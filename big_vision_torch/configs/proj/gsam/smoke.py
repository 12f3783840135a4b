"""GSAM smoke config (a tiny ViT on synthetic JPEGs): port of
big_vision_tpu/configs/proj/gsam/smoke.py.

  python -m big_vision_torch.trainers.proj.gsam.train --device cpu \
      --config big_vision_torch/configs/proj/gsam/smoke.py --workdir wd

Kept as there, all of it: ViT-mu/16 at 32px (sincos2d posemb, a random
head), 10 classes, `softmax_xent`, 64 synthetic JPEGs of 40x40 through
`decode_jpeg_and_inception_crop(32)|flip_lr|value_range|onehot|keep`, batch
16, 10 steps, a metric row every 5 steps and a checkpoint every 10, the
GSAM block (rho 0.6 to 0.1 with the learning rate, alpha 0.6,
`lr_min_ratio` 0: the rho schedule runs from lr 1e-3 down to 0), Adam, lr
1e-3, wd 1e-4, 2 warmup steps then cosine, no evals; the args `res`,
`total_steps` and `batch_size`.

Nothing is cut (`CUTS` is empty).
"""

from big_vision_torch.configs import common

CUTS = {}


def get_config(arg=None):
  arg = common.parse_arg(arg, res=32, total_steps=10, batch_size=16)
  config = {}
  config["seed"] = 0
  config["total_steps"] = arg.total_steps
  config["num_classes"] = 10
  config["loss"] = "softmax_xent"
  config["init_shapes"] = [(1, arg.res, arg.res, 3)]

  config["input"] = dict(
      data=dict(name="synthetic", n=64, num_classes=10, h=40, w=40),
      batch_size=arg.batch_size,
      shuffle_buffer_size=32, num_threads=4, prefetch=1,
      pp=(f"decode_jpeg_and_inception_crop({arg.res})|flip_lr"
          "|value_range(-1, 1)"
          "|onehot(10, key='label', key_result='labels')"
          "|keep('image', 'labels')"),
  )
  config["log_training_steps"] = 5
  config["ckpt_steps"] = 10

  config["model_name"] = "vit"
  config["model"] = dict(variant="mu/16", posemb="sincos2d",
                         head_zeroinit=False)

  config["gsam"] = dict(rho_max=0.6, rho_min=0.1, alpha=0.6,
                        lr_min_ratio=0.0, adaptive_perturbation=False,
                        minimize_fp=True)

  config["optax_name"] = "scale_by_adam"
  config["lr"] = 1e-3
  config["wd"] = 1e-4
  config["schedule"] = dict(warmup_steps=2, decay_type="cosine")
  config["evals"] = {}
  return config
