"""FlexiViT smoke config (a tiny FlexiViT, a random seqhw per step): port
of big_vision_tpu/configs/proj/flexi/smoke.py.

  python -m big_vision_torch.trainers.proj.flexi.train --device cpu \
      --config big_vision_torch/configs/proj/flexi/smoke.py --workdir wd
  python -m big_vision_torch.trainers.proj.flexi.distill --device cpu \
      --config big_vision_torch/configs/proj/flexi/smoke.py:mode=distill \
      --workdir wd

Kept as there, all of it: 64 synthetic JPEGs of 40x40 in 8 classes through
`decode|resize(32)|value_range|onehot|keep`, batch 16, 4 steps, metric
rows every 2 steps, no checkpoints, the seqhw draw from (2, 4) with equal
odds; `mode=train`: a FlexiViT of width 32, depth 1, 16x16 patches and a
2x2 posemb; `mode=distill`: that student and a ViT-mu/16 teacher "prof"
with the KL distance at t = 1; Adam with lr 1e-3 and wd 1e-4, 2 warmup
steps then cosine, no evals; the args `res`, `total_steps`, `batch_size`
and `mode`.

Nothing is cut (`CUTS` is empty).
"""

from big_vision_torch.configs import common

CUTS = {}


def get_config(arg=None):
  arg = common.parse_arg(arg, res=32, total_steps=4, batch_size=16,
                         mode="train")
  config = {}
  config["seed"] = 0
  config["total_steps"] = arg.total_steps
  config["num_classes"] = 8
  config["init_shapes"] = [(1, arg.res, arg.res, 3)]

  config["input"] = dict(
      data=dict(name="synthetic", n=64, num_classes=8, h=40, w=40),
      batch_size=arg.batch_size,
      shuffle_buffer_size=32, num_threads=4, prefetch=1,
      pp=(f"decode|resize({arg.res})|value_range(-1, 1)"
          "|onehot(8, key='label', key_result='labels')"
          "|keep('image', 'labels')"),
  )
  config["log_training_steps"] = 2
  config["ckpt_steps"] = None

  # A random patchification per step: a 32px image in 2x2 or 4x4 patches.
  config["flexi"] = dict(seqhw=dict(v=(2, 4), p=(1, 1)))

  if arg.mode == "train":
    config["model_name"] = "proj.flexi.vit"
    config["model"] = dict(width=32, depth=1, mlp_dim=64, num_heads=2,
                           patch_size=(16, 16), posemb_size=(2, 2),
                           head_zeroinit=False)
  else:  # distill
    config["student_name"] = "proj.flexi.vit"
    config["student"] = dict(num_classes=8, width=32, depth=1, mlp_dim=64,
                             num_heads=2, patch_size=(16, 16),
                             posemb_size=(2, 2), head_zeroinit=False)
    config["teachers"] = ["prof"]
    config["prof_name"] = "vit"
    config["prof"] = dict(num_classes=8, variant="mu/16",
                          head_zeroinit=False)
    config["distance"] = "kl"
    config["distance_kw"] = dict(t=1.0)

  config["optax_name"] = "scale_by_adam"
  config["lr"] = 1e-3
  config["wd"] = 1e-4
  config["schedule"] = dict(warmup_steps=2, decay_type="cosine")
  config["evals"] = {}
  return config
