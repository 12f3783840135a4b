"""Aliases of the reference's `pp.archive.*` module names: port of
big_vision_tpu/pp/archive.

Configs list pp op modules by name (`pp_modules = [..., "archive.randaug"]`)
and the trainers import them for their registry side effects; the ops are
registered by `pp/autoaugment.py`, and these aliases make the reference's
module names resolve to it.
"""
