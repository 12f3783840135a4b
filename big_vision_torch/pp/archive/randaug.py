"""Alias of big_vision_torch.pp.autoaugment under the reference's
pp.archive.randaug module name (registry side effects only)."""

from big_vision_torch.pp.autoaugment import *  # noqa: F401,F403
