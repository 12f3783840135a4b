"""The port's configs against the JAX configs they were copied from.

Each port config with a source in big_vision_tpu/configs is loaded next to
that source, at the default args and at `runlocal` (where the source has
it), and the two trees are diffed recursively, keys and values. Every
difference must be named by the port file's `CUTS` ({dotted key: reason};
at `runlocal` also `RUNLOCAL_CUTS`): a cut key names its subtree, and "*"
stands for any one key. Every cut key is also shown in the file's
docstring. This holds "the same config files drive both" for the configs
that were copied.
"""

import fnmatch
import importlib

import pytest

from big_vision_torch.configs import common_fewshot as t_fewshot
from big_vision_tpu.configs import common_fewshot as j_fewshot

# Port config -> the args it is diffed at (the JAX source has the same
# module path under big_vision_tpu.configs).
CONFIGS = {
    "vit_s16_i1k": (None, "runlocal"),
    "vit_i1k": (None, "runlocal"),
    "mlp_mixer_i1k": (None, "runlocal"),
    "transfer": (None, "runlocal", "model=vit-s16", "model=vit-s16,runlocal",
                 "model=bit-m-r50x1", "model=bit-m-r50x1,runlocal"),
    "smoke": (None,),
    "proj.flexivit.i21k_sup": (None, "runlocal"),
    "proj.flexivit.i21k_distill": (None, "runlocal"),
    "proj.flexivit.i1k_deit3_distill": (None, "runlocal"),
    "proj.distill.smoke": (None,),
    "quality_digits": (None, "runlocal=True"),
    "twin_dynamics": ("side=my,npz=x",),
    "vit_i21k": (None, "runlocal"),
    "proj.gsam.smoke": (None,),
    "proj.gsam.vit_i1k_gsam_no_aug": (None, "runlocal"),
    "proj.image_text.siglip_smoke": (None, "loss_impl=global"),
    "proj.image_text.siglip_lit_coco": (None, "runlocal", "img_head=True"),
    "load_and_eval": ("name=proj.image_text.siglip_smoke",
                      "name=proj.flexi.smoke,init=x.npz,batch_size=8"),
    "proj.flexi.smoke": (None, "mode=distill"),
    "proj.paligemma.smoke": (None, "attn=flash"),
    "proj.paligemma.transfers.cococap": (None, "runlocal", "final_split=True",
                                         "crop=ic,res=448"),
    "proj.cappa.smoke": (None, "res=32,total_steps=4"),
    "proj.cappa.pretrain": (None, "runlocal", "batch_size=64"),
    "proj.clippo.train_clippo": (None, "runlocal", "variant=L/16,res=256"),
    "proj.jet.smoke": (None, "res=32,total_steps=4"),
    "proj.jet.imagenet64": (None, "runlocal"),
    "proj.jetformer.smoke": (None, "use_adaptor=False"),
    "proj.jetformer.jetformer_imagenet2012": (None, "runlocal",
                                              "model_size=1p3B"),
    "bit_i1k": (None, "runlocal"),
    "proj.distill.bit_i1k": (None, "runlocal"),
    "proj.distill.bigsweep_flowers_pet": (None, "runlocal", "data=pet",
                                          "variant=long,crop=x"),
    "proj.distill.bigsweep_food_sun": (None, "runlocal", "data=sun",
                                       "variant=fast"),
}


def _plain(tree):
  """ConfigDicts, tuples and lists -> dicts and lists."""
  if hasattr(tree, "to_dict"):
    tree = tree.to_dict()
  if isinstance(tree, dict):
    return {k: _plain(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_plain(v) for v in tree]
  return tree


def _diff(jax_tree, port_tree, path=()):
  """[(dotted key, JAX value, port value)] of every difference."""
  if not (isinstance(jax_tree, dict) and isinstance(port_tree, dict)):
    return [] if jax_tree == port_tree else [
        (".".join(path), jax_tree, port_tree)]
  out = []
  for k in sorted(set(jax_tree) | set(port_tree), key=str):
    if k not in port_tree or k not in jax_tree:
      out.append((".".join(path + (str(k),)), jax_tree.get(k, "<absent>"),
                  port_tree.get(k, "<absent>")))
    else:
      out += _diff(jax_tree[k], port_tree[k], path + (str(k),))
  return out


def _named(key, cuts):
  parts = key.split(".")
  return any(len(c.split(".")) <= len(parts) and all(
      fnmatch.fnmatchcase(p, q) for p, q in zip(parts, c.split(".")))
             for c in cuts)


def _check(port_mod, jax_tree, port_tree, runlocal):
  cuts = dict(port_mod.CUTS)
  if runlocal:
    cuts.update(getattr(port_mod, "RUNLOCAL_CUTS", {}))
  for key in cuts:
    assert key in port_mod.__doc__, f"cut {key!r} not in the docstring"
  unnamed = [d for d in _diff(_plain(jax_tree), _plain(port_tree))
             if not _named(d[0], cuts)]
  assert not unnamed, "\n".join(f"{k}: JAX {j!r}, port {t!r}"
                                for k, j, t in unnamed)


@pytest.mark.parametrize("name,arg", [(n, a) for n, args in CONFIGS.items()
                                      for a in args])
def test_port_config_differs_only_by_its_cuts(name, arg):
  port_mod = importlib.import_module(f"big_vision_torch.configs.{name}")
  jax_mod = importlib.import_module(f"big_vision_tpu.configs.{name}")
  _check(port_mod, jax_mod.get_config(arg), port_mod.get_config(arg),
         runlocal="runlocal" in (arg or ""))


@pytest.mark.parametrize("arg", [None, "runlocal"])
def test_bit_i21k_differs_only_by_its_cuts(arg):
  # The JAX config takes no arg; `runlocal` is the port's.
  port_mod = importlib.import_module("big_vision_torch.configs.bit_i21k")
  jax_mod = importlib.import_module("big_vision_tpu.configs.bit_i21k")
  _check(port_mod, jax_mod.get_config(), port_mod.get_config(arg),
         runlocal=arg == "runlocal")


@pytest.mark.parametrize("runlocal", [False, True])
def test_fewshot_eval_differs_only_by_its_cuts(runlocal):
  _check(t_fewshot, j_fewshot.get_fewshot_lsr(runlocal=runlocal),
         t_fewshot.get_fewshot_lsr(runlocal=runlocal), runlocal)


def test_a_difference_outside_the_cuts_fails():
  port_mod = importlib.import_module("big_vision_torch.configs.vit_i1k")
  config = port_mod.get_config()
  config["input"]["pp"] = config["input"]["pp"].replace("randaug(2,15)|", "")
  with pytest.raises(AssertionError, match="input.pp"):
    _check(port_mod, importlib.import_module(
        "big_vision_tpu.configs.vit_i1k").get_config(), config, False)
