"""MLP-Mixer-B/16 on ImageNet-1k: port of
big_vision_tpu/configs/mlp_mixer_i1k.py.

  python -m big_vision_torch.train \
      --config big_vision_torch/configs/mlp_mixer_i1k.py --workdir wd
  python -m big_vision_torch.train --device cpu \
      --config big_vision_torch/configs/mlp_mixer_i1k.py:runlocal --workdir wd

Kept as there: Mixer-B/16 (`models/mlp_mixer.py`: width 768, 12 blocks,
token MLP 384, channel MLP 3072, f32 matmuls) with stochastic depth 0.1,
1000 classes, `sigmoid_xent` with the head bias at -6.9, the input pp
`decode_jpeg_and_inception_crop(224)|flip_lr|randaug(2,15)|value_range|
onehot|keep`, mixup p=0.5, gradient clip 1.0, scale_by_adam, lr 1e-3, wd
1e-4, 10,000 warmup steps then linear decay to 1e-5, 300 epochs, the
evals train, minival, val and v2 every 2500 steps, and the args
`variant` and `runlocal`. The Mixer has no attention: no kernel runs.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split is `common.stand_in`'s:
    synthetic JPEGs of 256x320 of the split's size, or the image folder
    `root`/train or `root`/val with the `root` arg;
  * input.batch_size: 512, one card's share of the JAX run's 4096: the
    largest power of two at which Mixer-B/16 in f32 fits in the H100's 80
    GB (chip_smoke.py prints the peak, over half of 80 GB);
  * model.variant, model.patch_size, model.hidden_dim, model.num_blocks,
    model.tokens_mlp_dim, model.channels_mlp_dim (runlocal): a Mixer of
    width 32 and 2 blocks in place of B/16, so that a CPU step is short.

Args (`:name=value,...`), besides the JAX config's: `root` (an ImageNet
folder with train/ and val/), `neval` (examples in every eval split; 32
with `runlocal`), `stop` (stop after that many steps), `log` (steps
between metric rows).
"""

from big_vision_torch.configs import common

CUTS = {
    "input.data": "no TFDS: imagenet2012 train[:99%] is synthetic JPEGs of "
                  "the split's size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "input.batch_size": "512: the largest power of two at which "
                        "Mixer-B/16 in f32 fits on one 80 GB card",
}
_SMALL = dict(patch_size=(16, 16), hidden_dim=32, num_blocks=2,
              tokens_mlp_dim=16, channels_mlp_dim=64)
RUNLOCAL_CUTS = {
    "model.variant": "a Mixer of width 32 and 2 blocks, so that a CPU step "
                     "is short",
    **{f"model.{k}": "(as model.variant)" for k in _SMALL},
}


def get_config(arg=None):
  arg = common.parse_arg(arg, variant="B/16", runlocal=False, root="",
                         neval=0, stop=0, log=50)
  config = {}

  config["seed"] = 0
  config["total_epochs"] = 300
  config["num_classes"] = 1000
  config["loss"] = "sigmoid_xent"
  config["init_head_bias"] = -6.9
  config["init_shapes"] = [(1, 224, 224, 3)]

  config["input"] = dict(
      data=common.stand_in("imagenet2012", "train[:99%]", root=arg.root),
      batch_size=512 if not arg.runlocal else 32,
      shuffle_buffer_size=250_000 if not arg.runlocal else 64,
      prefetch=2,
  )
  config["input"]["pp"] = (
      "decode_jpeg_and_inception_crop(224)|flip_lr|randaug(2,15)"
      "|value_range(-1, 1)"
      "|onehot(1000, key='label', key_result='labels')"
      "|keep('image', 'labels')")
  pp_eval = ("decode|resize_small(256)|central_crop(224)|value_range(-1, 1)"
             "|onehot(1000, key='{lbl}', key_result='labels')"
             "|keep('image', 'labels')")

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["model_name"] = "mlp_mixer"
  config["model"] = dict(variant=arg.variant, stoch_depth=0.1)
  if arg.runlocal:
    config["model"] = dict(_SMALL, stoch_depth=0.1)

  config["mixup"] = dict(p=0.5)

  config["grad_clip_norm"] = 1.0
  config["optax_name"] = "scale_by_adam"
  config["lr"] = 0.001
  config["wd"] = 1e-4
  config["schedule"] = dict(decay_type="linear", warmup_steps=10_000,
                            linear_end=1e-5)

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
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
