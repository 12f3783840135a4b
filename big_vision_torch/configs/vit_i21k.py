"""ViT pre-training on ImageNet-21k (AugReg, "How to train your ViT"): port
of big_vision_tpu/configs/vit_i21k.py.

  python -m big_vision_torch.train \
      --config big_vision_torch/configs/vit_i21k.py:variant=B/16 --workdir wd
  python -m big_vision_torch.train --device cpu \
      --config big_vision_torch/configs/vit_i21k.py:runlocal --workdir wd

Kept as there: the tables `MIXUP_DEF`, `RANDAUG_DEF` and `AUG_SETTING`
(B/16: `light2`, mixup p=0.2 and `randaug(2,10)`), the ViT (GAP, learned
posemb, no pre-logits layer, f32 matmuls, the attention gate "auto": K1
and K2 in f32 at T=196, D=64 for B/16), 21,843 classes, `sigmoid_xent`
with the head bias at -10, the input pp
`decode_jpeg_and_inception_crop(224)|flip_lr|<randaug>|value_range|onehot|
keep`, prefetch 8, `prefetch_to_device` 4, scale_by_adam with a bf16 first
moment, gradient clip 1.0, lr 1e-3, wd 1e-4, 10,000 warmup steps then
cosine, 300 epochs, checkpoints every 1000 steps, the evals test, val and
train every 1000 steps and the few-shot probe every 25,000 (val and the
probe on the pets stand-in alone with `runlocal`, at batch 32), and the
args `variant`, `runlocal` and `aug`.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split of imagenet21k is
    `common.stand_in`'s: synthetic JPEGs of 256x320 with 21,843 classes
    and the split's size (`full` taken as 13,151,276 examples, TFDS's
    catalog figure, which no copy of TFDS here can confirm; `full[51200:]`
    13,100,076, the eval splits 25,600 each), or the image folder
    `root`/train or `root`/val with the `root` arg;
  * evals.fewshot.datasets.*.data_train, evals.fewshot.datasets.*.data_test:
    the synthetic JPEG source of `configs/common_fewshot.py`;
  * input.pp, evals.*.pp_fn: `onehot(21843, key='label',
    key_result='labels')`, since the stand-ins give each example one class
    as `label` where imagenet21k's examples carry `labels`;
  * pp_modules: without "ops_text", which the port does not have; this pp
    uses none of its ops;
  * input.batch_size: 256, one card's share of the JAX run's 4096: the
    largest power of two at which AugReg ViT-B/16 in f32 fits in the H100's
    80 GB (512 ran out of memory in configs/vit_i1k.py; chip_smoke.py
    prints this config's peak at 256); the other variants keep it, not
    measured;
  * model.variant (runlocal): mu/16 in place of B/16, so that a CPU step
    takes a second.

Args (`:name=value,...`), besides the JAX config's: `root` (an ImageNet-21k
folder with train/ and val/), `neval` (examples in every classification
split, and in every few-shot split; 32 and 74 with `runlocal`), `fewshot`
(the few-shot datasets kept, joined by "+", or "none" for no probe),
`stop` (stop after that many steps), `log` (steps between metric rows),
`attn` (the attention impl, when not "auto").
"""

from big_vision_torch.configs import common
from big_vision_torch.configs import common_fewshot

CUTS = {
    "input.data": "no TFDS: imagenet21k full[51200:] is synthetic JPEGs of "
                  "the split's size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "evals.fewshot.datasets.*.data_train": "configs/common_fewshot.py",
    "evals.fewshot.datasets.*.data_test": "configs/common_fewshot.py",
    "pp_modules": "no ops_text in the port; this pp uses none of it",
    "input.pp": "onehot of the stand-in's 'label'",
    "evals.*.pp_fn": "onehot of the stand-in's 'label'",
    "input.batch_size": "256: the largest power of two at which ViT-B/16 "
                        "in f32 fits on one 80 GB card",
}
RUNLOCAL_CUTS = {"model.variant": "mu/16, so that a CPU step is short"}

MIXUP_DEF = {
    "none": dict(p=0.0, fold_in=None),
    "light1": dict(p=0.0, fold_in=None),
    "light2": dict(p=0.2, fold_in=None),
    "medium1": dict(p=0.2, fold_in=None),
    "medium2": dict(p=0.5, fold_in=None),
    "strong1": dict(p=0.5, fold_in=None),
    "strong2": dict(p=0.8, fold_in=None),
}

RANDAUG_DEF = {
    "none": "",
    "light1": "randaug(2,0)",  # Not nothing: the ops at magnitude 0.
    "light2": "randaug(2,10)",
    "medium1": "randaug(2,15)",
    "medium2": "randaug(2,15)",
    "strong1": "randaug(2,20)",
    "strong2": "randaug(2,20)",
}

# A good 30-300 epoch average per AugReg's Fig. 4.
AUG_SETTING = {
    "Ti/16": "none", "S/32": "none", "S/16": "light1",
    "B/32": "light2", "B/16": "light2", "L/16": "medium2",
}


def get_config(arg=None):
  arg = common.parse_arg(arg, variant="B/16", runlocal=False, aug="",
                         root="", neval=0, fewshot="", stop=0, log=50,
                         attn="auto")
  config = {}

  config["seed"] = 0
  config["total_epochs"] = 300
  config["num_classes"] = 21843
  config["init_head_bias"] = -10.0
  config["loss"] = "sigmoid_xent"

  aug = arg.aug or AUG_SETTING[arg.variant]

  config["input"] = dict(
      data=common.stand_in("imagenet21k", "full[51200:]", root=arg.root),
      batch_size=256,
      shuffle_buffer_size=250_000,
  )

  # The stand-ins give each example one class as `label`; imagenet21k's
  # TFDS examples carry theirs as `labels`.
  pp_common = ("|value_range(-1, 1)|onehot({onehot_args})"
               "|keep('image', 'labels')")
  pp_i21k = pp_common.format(
      onehot_args=f"{config['num_classes']}, key='label', "
                  "key_result='labels'")
  randaug = f"|{RANDAUG_DEF[aug]}" if RANDAUG_DEF[aug] else ""
  config["input"]["pp"] = (
      f"decode_jpeg_and_inception_crop(224)|flip_lr{randaug}" + pp_i21k)
  pp_eval = "decode|resize_small(256)|central_crop(224)"
  config["pp_modules"] = ["ops_general", "ops_image", "autoaugment"]

  config["input"]["prefetch"] = 8
  config["prefetch_to_device"] = 4
  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["model_name"] = "vit"
  config["model"] = dict(variant=arg.variant if not arg.runlocal else "mu/16",
                         pool_type="gap", posemb="learn")
  if arg.attn != "auto":
    config["model"]["attn_impl"] = arg.attn

  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["grad_clip_norm"] = 1.0
  config["lr"] = 0.001
  config["wd"] = 0.0001
  config["schedule"] = dict(warmup_steps=10_000, decay_type="cosine")
  config["mixup"] = MIXUP_DEF[aug]

  neval = arg.neval or (32 if arg.runlocal else 0)

  def eval_i21k(split):
    return dict(
        type="classification",
        data=common.stand_in("imagenet21k", split, root=arg.root, n=neval),
        pp_fn=pp_eval + pp_i21k,
        loss_name=config["loss"],
        log_steps=1000)

  config["evals"] = {}
  config["evals"]["test"] = eval_i21k("full[:25_600]")
  config["evals"]["val"] = eval_i21k("full[25_600:51_200]")
  config["evals"]["train"] = eval_i21k("full[51_200:76_800]")
  if arg.fewshot != "none":
    config["evals"]["fewshot"] = common_fewshot.get_fewshot_lsr(
        runlocal=arg.runlocal,
        examples=arg.neval or (74 if arg.runlocal else None),
        only=tuple(arg.fewshot.split("+")) if arg.fewshot else None)
    config["evals"]["fewshot"]["log_steps"] = 25_000

  if arg.runlocal:
    config["input"]["batch_size"] = 32
    config["input"]["shuffle_buffer_size"] = 100
    del config["evals"]["test"], config["evals"]["train"]
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
