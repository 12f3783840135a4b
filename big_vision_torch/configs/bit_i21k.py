"""BiT ResNet pre-training on ImageNet-21k: port of
big_vision_tpu/configs/bit_i21k.py.

  python -m big_vision_torch.train \
      --config big_vision_torch/configs/bit_i21k.py --workdir wd
  python -m big_vision_torch.train --device cpu \
      --config big_vision_torch/configs/bit_i21k.py:runlocal --workdir wd

Kept as there: the `bit_paper` model (`models/bit_paper.py`, ResNet-V2
with the paper's GN+WS) at depth 50 and width 1, f32 (the convs with TF32
off), 21,843 classes, `sigmoid_xent` with the head bias at -10, the input
pp `decode_jpeg_and_inception_crop(224)|flip_lr|value_range|onehot|keep`,
`big_vision.momentum_hp`, gradient clip 1.0, the linear scaling rule (lr
0.03 and wd 3e-5 per 256 examples of the batch), 5000 warmup steps then
cosine, 90 epochs, checkpoints every 1000 steps, the evals test, val and
train every 1000 steps and the few-shot probe every 25,000. The JAX
config takes no arg.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split of imagenet21k is
    `common.stand_in`'s: synthetic JPEGs of 256x320 with 21,843 classes
    and the split's size, or the image folder `root`/train or `root`/val
    with the `root` arg;
  * evals.fewshot.datasets.*.data_train, evals.fewshot.datasets.*.data_test:
    the synthetic JPEG source of `configs/common_fewshot.py`;
  * input.pp, evals.*.pp_fn: `onehot(21843, key='label',
    key_result='labels')`, since the stand-ins give each example one class
    as `label` where imagenet21k's examples carry `labels`;
  * input.batch_size, lr, wd: `BATCH`, one card's share of the JAX run's
    4096: the largest power of two at which R50x1 with its 21,843-class
    head trains in f32 on the H100's 80 GB (chip_smoke.py --bit tries an
    update at twice it); lr and wd follow it by the config's own linear
    rule;
  * model.depth, model.width (runlocal): R26x0.5, so that a CPU step is
    short; input.shuffle_buffer_size, evals.test, evals.train,
    evals.fewshot (runlocal): a buffer of 100, and only the val eval and
    the probe on the pets stand-in, at batch 32.

Args (`:name=value,...`), none in the JAX config: `runlocal`, `root` (an
ImageNet-21k folder with train/ and val/), `neval` (examples in every
classification split, and in every few-shot split; 32 and 74 with
`runlocal`), `fewshot` (the few-shot datasets kept, joined by "+", or
"none" for no probe), `stop` (stop after that many steps), `log` (steps
between metric rows).
"""

from big_vision_torch.configs import common
from big_vision_torch.configs import common_fewshot

# The per-card batch (see the docstring).
BATCH = 512

CUTS = {
    "input.data": "no TFDS: imagenet21k full[51200:] is synthetic JPEGs of "
                  "the split's size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "evals.fewshot.datasets.*.data_train": "configs/common_fewshot.py",
    "evals.fewshot.datasets.*.data_test": "configs/common_fewshot.py",
    "input.pp": "onehot of the stand-in's 'label'",
    "evals.*.pp_fn": "onehot of the stand-in's 'label'",
    "input.batch_size": "BATCH: the largest power of two at which R50x1 in "
                        "f32 trains on one 80 GB card",
    "lr": "the linear rule on the port's batch",
    "wd": "the linear rule on the port's batch",
}
RUNLOCAL_CUTS = {"model.depth": "R26x0.5, so that a CPU step is short",
                 "model.width": "(as model.depth)",
                 "input.shuffle_buffer_size": "100 on the CPU",
                 "evals.test": "val alone on the CPU",
                 "evals.train": "val alone on the CPU",
                 "evals.fewshot": "the pets stand-in alone on the CPU"}


def get_config(arg=None):
  arg = common.parse_arg(arg, runlocal=False, root="", neval=0, fewshot="",
                         stop=0, log=50)
  config = {}

  config["seed"] = 0
  config["total_epochs"] = 90
  config["num_classes"] = 21843
  config["init_head_bias"] = -10.0
  config["loss"] = "sigmoid_xent"

  config["input"] = dict(
      data=common.stand_in("imagenet21k", "full[51200:]", root=arg.root),
      batch_size=BATCH if not arg.runlocal else 32,
      shuffle_buffer_size=250_000 if not arg.runlocal else 100,
  )

  # The stand-ins give each example one class as `label`; imagenet21k's
  # TFDS examples carry theirs as `labels`.
  pp_common = ("|value_range(-1, 1)|onehot({onehot_args})"
               "|keep('image', 'labels')")
  pp_i21k = pp_common.format(
      onehot_args=f"{config['num_classes']}, key='label', "
                  "key_result='labels'")
  config["input"]["pp"] = ("decode_jpeg_and_inception_crop(224)|flip_lr"
                           + pp_i21k)
  pp_eval = "decode|resize_small(256)|central_crop(224)"

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["model_name"] = "bit_paper"
  config["model"] = (dict(depth=50, width=1.0) if not arg.runlocal
                     else dict(depth=26, width=0.5))

  config["optax_name"] = "big_vision.momentum_hp"
  config["grad_clip_norm"] = 1.0
  # Linear scaling rule; re-sweep when sweeping batch_size.
  config["lr"] = (0.03 / 256) * config["input"]["batch_size"]
  config["wd"] = (3e-5 / 256) * config["input"]["batch_size"]
  config["schedule"] = dict(decay_type="cosine", warmup_steps=5000)

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
    del config["evals"]["test"], config["evals"]["train"]
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
