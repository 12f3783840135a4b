"""Smoke config: a tiny ViT on synthetic JPEGs that trains anywhere in
seconds, through the whole stack.

  python -m big_vision_torch.train --device cpu \
      --config big_vision_torch/configs/smoke.py --workdir /tmp/bvt_smoke

Source: big_vision_tpu/configs/smoke.py, the JAX package's full-stack
config: synthetic JPEG source -> host decode and inception crop -> device
pp -> ViT-mu/16 forward and backward -> optimizer with gradient clip and
mixup -> checkpoint -> classification eval (`decode|resize_small|
central_crop` on 48 more synthetic JPEGs) every 10 steps.

Cut: the `seq_mesh` arg (context parallelism over a device mesh: the port
runs one device), and `init_shapes` (the port's trainer takes the model's
input shape from the data, as the JAX trainer does where a config has no
`init_shapes`; here both give (1, res, res, 3)).

`CUTS` names the keys that differ from the JAX config: init_shapes.

Args (`:name=value,...`): `res` (32), `total_steps` (20), `batch_size`
(16), `mixup` (True: p=0.2), `attn` ("auto"), `log` (5), `stop` (0: none),
`ckpt` (10), as in the JAX config.
"""

from big_vision_torch.configs import common

CUTS = {"init_shapes": "the trainer takes the input shape from the data"}


def get_config(arg=None):
  arg = common.parse_arg(arg, res=32, total_steps=20, batch_size=16,
                         mixup=True, attn="auto", log=5, stop=0, ckpt=10)
  config = {}

  config["seed"] = 0
  config["total_steps"] = arg.total_steps
  config["num_classes"] = 10
  config["loss"] = "softmax_xent"

  config["input"] = dict(
      data=dict(name="synthetic", n=256, num_classes=10, h=48, w=56),
      batch_size=arg.batch_size,
      shuffle_buffer_size=64,
      num_threads=4,
      prefetch=1,
      pp=(f"decode_jpeg_and_inception_crop({arg.res})|flip_lr"
          "|value_range(-1, 1)"
          "|onehot(10, key='label', key_result='labels')"
          "|keep('image', 'labels')"),
  )

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = arg.ckpt
  if arg.stop:
    config["stop_after_steps"] = arg.stop

  config["model_name"] = "vit"
  config["model"] = dict(variant="mu/16", rep_size=True, pool_type="gap",
                         posemb="sincos2d", attn_impl=arg.attn)

  config["grad_clip_norm"] = 1.0
  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["lr"] = 0.001
  config["wd"] = 0.0001
  config["schedule"] = dict(warmup_steps=5, decay_type="cosine")
  if arg.mixup:
    config["mixup"] = dict(p=0.2)

  pp_eval = (f"decode|resize_small({arg.res + 8})|central_crop({arg.res})"
             "|value_range(-1, 1)"
             "|onehot(10, key='label', key_result='labels')"
             "|keep('image', 'labels')")
  config["evals"] = dict(
      val=dict(type="classification",
               data=dict(name="synthetic", n=48, num_classes=10, h=48, w=56),
               pp_fn=pp_eval, loss_name=config["loss"], log_steps=10),
  )
  return config
