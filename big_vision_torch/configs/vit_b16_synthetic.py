"""ViT-B/16 at 224px trained on synthetic JPEGs: the port's training path.

  python -m big_vision_torch.train \
      --config big_vision_torch/configs/vit_b16_synthetic.py --workdir wd
  python -m big_vision_torch.train --device cpu \
      --config big_vision_torch/configs/vit_b16_synthetic.py:runlocal \
      --workdir wd

Source: the training step of the repository's bench.py (bench.py:166-197):
the same model (B/16, sincos2d posemb, GAP, bf16 matmuls, fused attention),
optimizer (scale_by_adam with a bf16 first moment, lr 1e-3, wd 1e-4, 100
warmup steps then cosine over 10,000), loss (softmax_xent), batch (256),
and input: the synthetic source of 16384 JPEGs of 256x320 (512 unique
images, 1000 classes), decoded on the host into YUV 4:2:0 planes with an
inception crop to 224 (`decode_jpeg_and_inception_crop_yuv`), made RGB,
flipped, scaled and one-hot on the device, on bench.py's host threads
(4 per core, between 4 and 16), prefetching 4 batches.

Evaluation, as configs/vit_s16_i1k.py:50, 71-86 builds its `val`: a
classification eval of `softmax_xent` and top-1 every 2500 steps, with
`decode|resize_small(256)|central_crop(224)` and the same device ops, on a
synthetic JPEG source of 1024 examples of 256x320 (in place of ImageNet's
validation split); the trainer runs it at step 0 too.

Args (`:name=value,...`): `runlocal` (the tiny version for CPU tests:
mu/16, 32px, batch 8, 3 steps, an eval of 24 images), `stop` (stop after
that many steps, the schedule unchanged), `log` (steps between metric
rows), `attn` (the attention impl: "flash" or "xla"), `dtype` (the matmul
dtype, default "bfloat16").
"""

import os

from big_vision_torch.configs import common


def get_config(arg=None):
  arg = common.parse_arg(arg, runlocal=False, stop=0, log=50, attn="flash",
                         dtype="bfloat16")
  config = {}
  config["seed"] = 0
  config["total_steps"] = 10_000
  config["num_classes"] = 1000
  config["loss"] = "softmax_xent"
  res, eval_small = 224, 256
  config["input"] = dict(
      data=dict(name="synthetic", n=16384, num_classes=1000, h=256, w=320,
                unique_images=512),
      batch_size=256,
      shuffle_buffer_size=1024,
      num_threads=min(16, max(4, (os.cpu_count() or 1) * 4)),
      prefetch=4,
  )
  config["model_name"] = "vit"
  config["model"] = dict(variant="B/16", posemb="sincos2d", pool_type="gap",
                         dtype_mm=arg.dtype, attn_impl=arg.attn)
  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["lr"] = 1e-3
  config["wd"] = 1e-4
  config["schedule"] = dict(warmup_steps=100, decay_type="cosine")
  config["log_training_steps"] = arg.log
  eval_data = dict(name="synthetic", n=1024, num_classes=1000, h=256, w=320)

  if arg.runlocal:
    res, eval_small = 32, 36
    config["total_steps"] = 3
    config["schedule"] = dict(warmup_steps=1, decay_type="cosine")
    config["input"]["batch_size"] = 8
    config["input"]["data"].update(n=64, h=40, w=48, unique_images=16)
    config["input"]["shuffle_buffer_size"] = 16
    config["input"]["num_threads"] = 2
    config["input"]["prefetch"] = 1
    config["model"]["variant"] = "mu/16"
    config["log_training_steps"] = 1
    eval_data.update(n=24, h=40, w=48, unique_images=24)
  pp_common = ("|value_range(-1, 1)"
               "|onehot(1000, key='label', key_result='labels')"
               "|keep('image', 'labels')")
  config["input"]["pp"] = (
      f"decode_jpeg_and_inception_crop_yuv({res})|yuv420_to_rgb|flip_lr"
      + pp_common)
  config["evals"] = dict(val=dict(
      type="classification",
      data=eval_data,
      pp_fn=f"decode|resize_small({eval_small})|central_crop({res})"
      + pp_common,
      loss_name=config["loss"],
      log_steps=2500,
  ))
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
