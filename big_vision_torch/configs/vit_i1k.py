"""AugReg ViT on ImageNet-1k ("How to train your ViT"): port of
big_vision_tpu/configs/vit_i1k.py.

  python -m big_vision_torch.train \
      --config big_vision_torch/configs/vit_i1k.py:variant=B/16 --workdir wd
  python -m big_vision_torch.train --device cpu \
      --config big_vision_torch/configs/vit_i1k.py:runlocal --workdir wd

Kept as there: the variant's augmentation setting (`aug`, or the table
per variant: B/16 `medium2`) through the `MIXUP_DEF` and `RANDAUG_DEF`
tables (`medium2`: mixup p=0.5 and `randaug(2,15)`; `light1`:
`randaug(2,0)`), the ViT (GAP, sincos2d posemb, no pre-logits layer, f32
matmuls, the attention gate "auto": K1 and K2 at T=196), 1000 classes,
`sigmoid_xent` with the head bias at -6.9, the input pp
`decode_jpeg_and_inception_crop(224)|flip_lr|<randaug>|value_range|onehot|
keep`, prefetch 8, scale_by_adam with a bf16 first moment, gradient clip
1.0, lr 1e-3, wd 1e-4, 10,000 warmup steps then cosine, 300 epochs, the
evals train, minival, val and v2 every 2500 steps (val alone with
`runlocal`), and the args `variant`, `runlocal` and `aug`.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split is `common.stand_in`'s:
    synthetic JPEGs of 256x320 of the split's size, or the image folder
    `root`/train or `root`/val with the `root` arg;
  * input.batch_size: 256, one card's share of the JAX run's 4096: the
    largest power of two at which ViT-B/16 in f32 fits in the H100's 80
    GB (512 runs out of memory; chip_smoke.py prints the peak at 256);
    the other variants keep it, not measured;
  * model.variant (runlocal): mu/16 in place of B/16, so that a CPU step
    takes a second.

Args (`:name=value,...`), besides the JAX config's: `root` (an ImageNet
folder with train/ and val/), `neval` (examples in every eval split; 32
with `runlocal`), `stop` (stop after that many steps), `log` (steps
between metric rows), `attn` (the attention impl, when not "auto").
"""

from big_vision_torch.configs import common

CUTS = {
    "input.data": "no TFDS: imagenet2012 train[:99%] is synthetic JPEGs of "
                  "the split's size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "input.batch_size": "256: the largest power of two at which ViT-B/16 "
                        "in f32 fits on one 80 GB card",
}
RUNLOCAL_CUTS = {"model.variant": "mu/16, so that a CPU step is short"}

MIXUP_DEF = {
    "none": dict(p=0.0),
    "light1": dict(p=0.0),
    "light2": dict(p=0.2),
    "medium1": dict(p=0.2),
    "medium2": dict(p=0.5),
    "strong1": dict(p=0.5),
    "strong2": dict(p=0.8),
}

RANDAUG_DEF = {
    "none": "",
    "light1": "randaug(2,0)|",
    "light2": "randaug(2,10)|",
    "medium1": "randaug(2,15)|",
    "medium2": "randaug(2,15)|",
    "strong1": "randaug(2,20)|",
    "strong2": "randaug(2,20)|",
}


def get_config(arg=None):
  arg = common.parse_arg(arg, variant="B/16", runlocal=False, aug="",
                         root="", neval=0, stop=0, log=50, attn="auto")
  config = {}

  config["seed"] = 0
  config["total_epochs"] = 300
  config["num_classes"] = 1000
  config["loss"] = "sigmoid_xent"
  config["init_head_bias"] = -6.9
  config["init_shapes"] = [(1, 224, 224, 3)]

  aug_setting = arg.aug or {
      "Ti/16": "light1", "S/32": "medium1", "S/16": "medium2",
      "B/32": "medium2", "B/16": "medium2", "L/16": "medium2",
  }[arg.variant]

  config["input"] = dict(
      data=common.stand_in("imagenet2012", "train[:99%]", root=arg.root),
      batch_size=256 if not arg.runlocal else 32,
      shuffle_buffer_size=250_000 if not arg.runlocal else 64,
      prefetch=8,
  )
  pp_common = ("|value_range(-1, 1)"
               "|onehot(1000, key='{lbl}', key_result='labels')"
               "|keep('image', 'labels')")
  config["input"]["pp"] = (
      "decode_jpeg_and_inception_crop(224)|flip_lr|"
      + RANDAUG_DEF[aug_setting] + pp_common.format(lbl="label").lstrip("|"))
  pp_eval = "decode|resize_small(256)|central_crop(224)" + pp_common

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["model_name"] = "vit"
  config["model"] = dict(variant=arg.variant if not arg.runlocal else "mu/16",
                         rep_size=False, pool_type="gap", posemb="sincos2d")
  if arg.attn != "auto":
    config["model"]["attn_impl"] = arg.attn

  config["mixup"] = MIXUP_DEF[aug_setting]

  config["grad_clip_norm"] = 1.0
  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["lr"] = 0.001
  config["wd"] = 0.0001
  config["schedule"] = dict(warmup_steps=10_000, decay_type="cosine")

  neval = arg.neval or (32 if arg.runlocal else 0)

  def get_eval(split, dataset="imagenet2012", lbl="label"):
    return dict(type="classification",
                data=common.stand_in(dataset, split, root=arg.root, n=neval),
                pp_fn=pp_eval.format(lbl=lbl),
                loss_name=config["loss"], log_steps=2500)
  config["evals"] = dict(
      train=get_eval("train[:2%]"),
      minival=get_eval("train[99%:]"),
      val=get_eval("validation"),
      v2=get_eval("test", dataset="imagenet_v2"),
  )
  if arg.runlocal:
    config["evals"] = dict(val=config["evals"]["val"])
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
