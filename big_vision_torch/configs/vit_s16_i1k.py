"""ViT-S/16 on ImageNet-1k, the 90-epoch baseline: port of
big_vision_tpu/configs/vit_s16_i1k.py.

  python -m big_vision_torch.train \
      --config big_vision_torch/configs/vit_s16_i1k.py --workdir wd
  python -m big_vision_torch.train --device cpu \
      --config big_vision_torch/configs/vit_s16_i1k.py:runlocal --workdir wd

Kept as there: ViT-S/16 (GAP, sincos2d posemb, a tanh pre-logits layer,
f32 matmuls, the JAX package's attention gate "auto": at T=196 the fused
kernels K1 and K2), 1000 classes, `softmax_xent`, the input pp
`decode_jpeg_and_inception_crop(224)|flip_lr|randaug(2, 10)|value_range|
onehot|keep`, scale_by_adam with a bf16 first moment, gradient clip 1.0,
lr 1e-3, wd 1e-4, 10,000 warmup steps then cosine, 90 epochs, mixup
p=0.2, the evals train, minival, val, v2 and real every 2500 steps (val
alone with `runlocal`), and the args `variant`, `runlocal`,
`total_epochs` and `randaug`.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split is `common.stand_in`'s:
    synthetic JPEGs of 256x320 of the split's size (imagenet2012
    train[:99%] 1,268,355, so 90 epochs are as many steps as there), or
    the image folder `root`/train or `root`/val with the `root` arg;
  * evals.real.pp_fn: ReaL's multi-labels (`real_label`) have no stand-in;
    its eval one-hots the stand-in's `label`;
  * model.variant (runlocal): mu/16 in place of S/16, so that a CPU step
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
    "evals.real.pp_fn": "no stand-in for ReaL's multi-labels (real_label): "
                        "one-hot of the stand-in's label",
}
RUNLOCAL_CUTS = {"model.variant": "mu/16, so that a CPU step is short"}


def get_config(arg=None):
  arg = common.parse_arg(arg, variant="S/16", runlocal=False,
                         total_epochs=90, randaug="2-10", root="", neval=0,
                         stop=0, log=50, attn="auto")
  config = {}

  config["seed"] = 0
  config["total_epochs"] = arg.total_epochs
  config["num_classes"] = 1000
  config["loss"] = "softmax_xent"
  config["init_shapes"] = [(1, 224, 224, 3)]

  config["input"] = dict(
      data=common.stand_in("imagenet2012", "train[:99%]", root=arg.root),
      batch_size=1024 if not arg.runlocal else 32,
      shuffle_buffer_size=250_000 if not arg.runlocal else 64,
      prefetch=2,
  )

  pp_common = (
      "|value_range(-1, 1)"
      "|onehot(1000, key='{lbl}', key_result='labels')"
      "|keep('image', 'labels')"
  )
  ra = ""
  if arg.randaug:
    layers, magnitude = map(int, arg.randaug.split("-"))
    ra = f"|randaug({layers}, {magnitude})"
  config["input"]["pp"] = (
      f"decode_jpeg_and_inception_crop(224)|flip_lr{ra}"
      + pp_common.format(lbl="label"))
  pp_eval = "decode|resize_small(256)|central_crop(224)" + pp_common

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["model_name"] = "vit"
  config["model"] = dict(
      variant=arg.variant if not arg.runlocal else "mu/16",
      rep_size=True,
      pool_type="gap",
      posemb="sincos2d",
  )
  if arg.attn != "auto":
    config["model"]["attn_impl"] = arg.attn

  config["grad_clip_norm"] = 1.0
  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["lr"] = 0.001
  config["wd"] = 0.0001
  config["schedule"] = dict(warmup_steps=10_000, decay_type="cosine")
  config["mixup"] = dict(p=0.2)

  neval = arg.neval or (32 if arg.runlocal else 0)

  def get_eval(split, dataset="imagenet2012", lbl="label"):
    return dict(
        type="classification",
        data=common.stand_in(dataset, split, root=arg.root, n=neval),
        pp_fn=pp_eval.format(lbl=lbl),
        loss_name=config["loss"],
        log_steps=2500,
    )
  config["evals"] = dict(
      train=get_eval("train[:2%]"),
      minival=get_eval("train[99%:]"),
      val=get_eval("validation"),
      v2=get_eval("test", dataset="imagenet_v2"),
      real=get_eval("validation", dataset="imagenet2012_real"),
  )
  if arg.runlocal:
    config["evals"] = dict(val=config["evals"]["val"])
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
