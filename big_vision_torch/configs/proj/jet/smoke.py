"""Jet smoke config (a tiny flow on synthetic JPEGs): port of
big_vision_tpu/configs/proj/jet/smoke.py.

  python -m big_vision_torch.trainers.proj.jet.train --device cpu \
      --config big_vision_torch/configs/proj/jet/smoke.py --workdir wd

Kept as there, all of it: 64 synthetic JPEGs of 24x24 through
`decode|resize(16)|value_range(0, 1)|keep('image')`, batch 16, 15 steps, a
metric row every 5 steps and a checkpoint every 10, the flow (4 couplings
of one ViT block, emb 32, 2 heads, ps 4: T = 16 tokens), Adam, lr 1e-3,
no weight decay, 2 warmup steps then cosine (the masks frozen by the
trainer), no evals; the args `res`, `total_steps` and `batch_size`.

Nothing is cut (`CUTS` is empty).
"""

from big_vision_torch.configs import common

CUTS = {}


def get_config(arg=None):
  arg = common.parse_arg(arg, res=16, total_steps=15, batch_size=16)
  config = {}
  config["seed"] = 0
  config["total_steps"] = arg.total_steps
  config["init_shapes"] = [(1, arg.res, arg.res, 3)]

  config["input"] = dict(
      data=dict(name="synthetic", n=64, num_classes=8, h=24, w=24),
      batch_size=arg.batch_size,
      shuffle_buffer_size=32, num_threads=4, prefetch=1,
      pp=(f"decode|resize({arg.res})|value_range(0, 1)"
          "|keep('image')"),
  )
  config["log_training_steps"] = 5
  config["ckpt_steps"] = 10

  config["model_name"] = "proj.jet.jet"
  config["model"] = dict(depth=4, block_depth=1, emb_dim=32, num_heads=2,
                         ps=4)

  config["optax_name"] = "scale_by_adam"
  config["lr"] = 1e-3
  config["wd"] = 0.0
  config["schedule"] = dict(warmup_steps=2, decay_type="cosine")
  config["evals"] = {}
  return config
