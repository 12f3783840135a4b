"""BiT-ResNet50x1 on ImageNet-1k from scratch: port of
big_vision_tpu/configs/bit_i1k.py.

  python -m big_vision_torch.train \
      --config big_vision_torch/configs/bit_i1k.py --workdir wd
  python -m big_vision_torch.train --device cpu \
      --config big_vision_torch/configs/bit_i1k.py:runlocal --workdir wd

Kept as there: the `bit` model (`models/bit.py`, ResNet-V1 with GN+WS) at
depth 50 and width 1, f32 (the convs with TF32 off), 1000 classes,
`softmax_xent`, the input pp `decode_jpeg_and_inception_crop(224)|flip_lr|
onehot|value_range|keep`, `big_vision.momentum_hp` (SGD with a bf16
momentum), gradient clip 1.0, the linear scaling rule (lr 0.1 and wd 1e-4
per 256 examples of the batch), 1000 warmup steps then cosine, 90 epochs,
the evals train, minival, val, v2 and real every 1000 steps with their
`final_data` cache (val alone, uncached, with `runlocal`), and the arg
`runlocal`.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split is `common.stand_in`'s:
    synthetic JPEGs of 256x320 of the split's size, or the image folder
    `root`/train or `root`/val with the `root` arg;
  * evals.real.pp_fn: `onehot` of the stand-in's 'label', since the
    stand-in gives each example one class where imagenet2012_real's
    examples carry a list of ReaL labels as 'real_label';
  * input.batch_size, lr, wd: `BATCH`, one card's share of the JAX run's
    4096: the largest power of two at which R50x1 in f32 trains on the
    H100's 80 GB (chip_smoke.py --bit tries an update at twice it); lr and
    wd follow it by the config's own linear rule;
  * model.depth, model.width (runlocal): R26x0.5, so that a CPU step is
    short.

Args (`:name=value,...`), besides the JAX config's: `root` (an ImageNet
folder with train/ and val/), `neval` (examples in every eval split; 32
with `runlocal`), `stop` (stop after that many steps), `log` (steps
between metric rows).
"""

from big_vision_torch.configs import common

# The per-card batch (see the docstring).
BATCH = 256

CUTS = {
    "input.data": "no TFDS: imagenet2012 train[:99%] is synthetic JPEGs of "
                  "the split's size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "evals.real.pp_fn": "onehot of the stand-in's 'label'",
    "input.batch_size": "BATCH: the largest power of two at which R50x1 in "
                        "f32 trains on one 80 GB card",
    "lr": "the linear rule on the port's batch",
    "wd": "the linear rule on the port's batch",
}
RUNLOCAL_CUTS = {"model.depth": "R26x0.5, so that a CPU step is short",
                 "model.width": "(as model.depth)"}


def get_config(arg=None):
  arg = common.parse_arg(arg, runlocal=False, root="", neval=0, stop=0,
                         log=50)
  config = {}

  config["seed"] = 0
  config["total_epochs"] = 90
  config["num_classes"] = 1000
  config["loss"] = "softmax_xent"
  config["init_shapes"] = [(1, 224, 224, 3)]

  config["input"] = dict(
      data=common.stand_in("imagenet2012", "train[:99%]", root=arg.root),
      batch_size=BATCH if not arg.runlocal else 32,
      shuffle_buffer_size=250_000 if not arg.runlocal else 100,
  )
  pp_common = ("|onehot(1000, key='{lbl}', key_result='labels')"
               "|value_range(-1, 1)|keep('image', 'labels')")
  config["input"]["pp"] = ("decode_jpeg_and_inception_crop(224)|flip_lr"
                           + pp_common.format(lbl="label"))
  pp_eval = "decode|resize_small(256)|central_crop(224)" + pp_common

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["model_name"] = "bit"
  config["model"] = (dict(depth=50, width=1.0) if not arg.runlocal
                     else dict(depth=26, width=0.5))

  config["optax_name"] = "big_vision.momentum_hp"
  config["grad_clip_norm"] = 1.0
  # Linear scaling rule for both lr and wd.
  config["wd"] = (1e-4 / 256) * config["input"]["batch_size"]
  config["lr"] = (0.1 / 256) * config["input"]["batch_size"]
  config["schedule"] = dict(decay_type="cosine", warmup_steps=1000)

  neval = arg.neval or (32 if arg.runlocal else 0)

  def get_eval(split, dataset="imagenet2012", lbl="label"):
    return dict(type="classification",
                data=common.stand_in(dataset, split, root=arg.root,
                                     n=neval),
                pp_fn=pp_eval.format(lbl=lbl), loss_name=config["loss"],
                log_steps=1000, cache="final_data")
  config["evals"] = dict(
      train=get_eval("train[:2%]"),
      minival=get_eval("train[99%:]"),
      val=get_eval("validation"),
      v2=get_eval("test", dataset="imagenet_v2"),
      # The stand-in's examples have one 'label', not 'real_label'.
      real=get_eval("validation", dataset="imagenet2012_real"),
  )
  if arg.runlocal:
    config["evals"] = dict(val=config["evals"]["val"])
    config["evals"]["val"]["cache"] = "none"
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
