"""Jet on downsampled ImageNet 64x64 (arXiv:2412.15129): port of
big_vision_tpu/configs/proj/jet/imagenet64.py.

  python -m big_vision_torch.trainers.proj.jet.train --workdir wd \
      --config big_vision_torch/configs/proj/jet/imagenet64.py

Kept as there: 200 epochs of `decode|resize(64)|value_range(0, 1)|keep`,
batch 1024, the flow (depth 32 couplings, channels, channels, spatial in
turn; random channel permutations; checkerboard, vstripes and hstripes
and their "-inv"; ViT conditioners of 2 blocks, emb 512, 8 heads; ps 4:
T = 256 tokens of 48 channels, the conditioners' attention at D = 64, the
fused kernels K1 and K2 in f32 under the gate "auto"), Adam with b2 0.95,
lr 3e-4, wd 1e-5, gradient clip 1.0, a cosine schedule with 10% warmup
(the masks frozen), metric rows every 50 steps, a checkpoint every 1000,
the `mean` eval of `bits_per_dim` on the validation split every 1000
steps; the arg `runlocal` (batch 32, shuffle buffer 50).

Cut (`CUTS`):
  * input.data, evals.val.data: no TFDS; `downsampled_imagenet/64x64`'s
    train (1,281,167) and validation (50,000) splits are
    `common.stand_in`'s synthetic JPEGs of 64x64 of the split's size.

Args (`:name=value,...`), besides the JAX config's: `batch_size` (the
training batch, 1024 by default), `neval` (examples in the validation
split), `stop` (stop after that many steps), `log` (steps between metric
rows), `attn` (the conditioners' attention impl, when not "auto").
"""

from big_vision_torch.configs import common

CUTS = {
    "input.data": "no TFDS: synthetic JPEGs of 64x64, of the split's size",
    "evals.val.data": "no TFDS: synthetic JPEGs of 64x64, of the split's "
                      "size",
}


def get_config(arg=None):
  arg = common.parse_arg(arg, runlocal=False, batch_size=1024, neval=0,
                         stop=0, log=50, attn="auto")
  config = {}
  config["seed"] = 0
  config["total_epochs"] = 200

  config["input"] = dict(
      data=common.stand_in("downsampled_imagenet/64x64", "train"),
      batch_size=arg.batch_size if not arg.runlocal else 32,
      shuffle_buffer_size=250_000 if not arg.runlocal else 50,
      pp="decode|resize(64)|value_range(0, 1)|keep('image')",
  )
  config["init_shapes"] = [(1, 64, 64, 3)]
  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["model_name"] = "proj.jet.jet"
  config["model"] = dict(
      depth=32, block_depth=2, emb_dim=512, num_heads=8, ps=4,
      kinds=("channels", "channels", "spatial"),
      channels_coupling_projs=("random",),
      spatial_coupling_projs=("checkerboard", "checkerboard-inv",
                              "vstripes", "vstripes-inv",
                              "hstripes", "hstripes-inv"))
  if arg.attn != "auto":
    config["model"]["attn_impl"] = arg.attn

  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(b2=0.95)
  config["lr"] = 3e-4
  config["wd"] = 1e-5
  config["schedule"] = [
      (".*FREEZE_ME.*", None),
      (".*", dict(decay_type="cosine", warmup_percent=0.1)),
  ]
  config["grad_clip_norm"] = 1.0

  config["evals"] = {}
  config["evals"]["val"] = dict(
      type="mean", pred="bits_per_dim",
      data=common.stand_in("downsampled_imagenet/64x64", "validation",
                           n=arg.neval),
      pp_fn=config["input"]["pp"], log_steps=1000)
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
