"""Eval-only config: a named training config with its training stripped:
port of big_vision_tpu/configs/load_and_eval.py (the `total_steps=0`
pattern).

  python -m big_vision_torch.tools.eval_only --workdir wd \
      --config big_vision_torch/configs/load_and_eval.py:name=vit_i1k,init=<f.npz>

The named config (`big_vision_torch.configs.<name>`, dotted names such as
`proj.image_text.siglip_lit_coco` too) gets `total_steps` 0 and no
`total_epochs`, `input.batch_size` = `batch_size` (512), and `model_init`
= `init` where given (an `.npz`, or a trainer's checkpoint file).

Cut (`CUTS`): none of the JAX config's keys. The args that `name`'s
config takes (e.g. `neval`, `img_init`) are passed on to it; the JAX config
reads them and calls the named config without arguments.
"""

import importlib

from big_vision_torch.configs import common

CUTS = {}


def get_config(arg=None):
  arg = common.parse_arg(arg, name="vit_i1k", init="", batch_size=512,
                         lazy=True)
  extra = {k: v for k, v in vars(arg).items()
           if k not in ("name", "init", "batch_size")}
  base_mod = importlib.import_module(f"big_vision_torch.configs.{arg.name}")
  config = base_mod.get_config(
      ",".join(f"{k}={v}" for k, v in extra.items()) or None)
  config["total_steps"] = 0
  config.pop("total_epochs", None)  # total_steps=0 is the only duration
  config["input"]["batch_size"] = arg.batch_size
  if arg.init:
    config["model_init"] = arg.init
  return config
