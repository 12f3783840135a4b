"""SigLIP smoke config (a tiny two-tower model on synthetic image-text
pairs): port of big_vision_tpu/configs/proj/image_text/siglip_smoke.py.

  python -m big_vision_torch.trainers.proj.image_text.siglip --device cpu \
      --config big_vision_torch/configs/proj/image_text/siglip_smoke.py \
      --workdir wd

Kept as there, all of it: captions from the synthetic labels by `strfmt`
("photo number {label}"), tokenized by the `test(128)` tokenizer to 8
tokens with a sticky eos; ViT-mu/16 at 32px (GAP) and the text transformer
mu (vocab 128, "last" pooling), 32-wide embeddings, t = 10 and b = -2 at
init, the chunked sigmoid loss, batch 32, 30 steps, Adam with lr 1e-3 and
wd 1e-4, 5 warmup steps then cosine, metric rows every 10 steps and a
checkpoint every 20, the contrastive eval on 32 examples every 15 steps;
the args `res`, `total_steps`, `batch_size` and `loss_impl`.

Nothing is cut (`CUTS` is empty).
"""

from big_vision_torch.configs import common

CUTS = {}


def get_config(arg=None):
  arg = common.parse_arg(arg, res=32, total_steps=30, batch_size=32,
                         loss_impl="chunked")
  config = {}

  config["seed"] = 0
  config["total_steps"] = arg.total_steps
  config["loss_impl"] = arg.loss_impl
  config["init_shapes"] = [(1, arg.res, arg.res, 3), (1, 8)]

  tokenizer = ("tokenize(8, eos='sticky', model='test(128)', pad_value=1, "
               "inkey='text', outkey='labels')")
  config["input"] = dict(
      data=dict(name="synthetic", n=128, num_classes=8, h=40, w=40),
      batch_size=arg.batch_size,
      shuffle_buffer_size=64,
      num_threads=4,
      prefetch=1,
      pp=(f"decode|resize({arg.res})|value_range(-1, 1)"
          "|strfmt('photo number {label}', outkey='text')"
          f"|{tokenizer}|keep('image', 'labels')"),
  )

  config["log_training_steps"] = 10
  config["ckpt_steps"] = 20

  config["model_name"] = "proj.image_text.two_towers"
  config["model"] = dict(
      image=dict(variant="mu/16", pool_type="gap", head_zeroinit=False),
      text=dict(variant="mu", vocab_size=128),
      out_dim=32,
      temperature_init=10.0,
      bias_init=-2.0,
  )

  config["optax_name"] = "scale_by_adam"
  config["lr"] = 1e-3
  config["wd"] = 1e-4
  config["schedule"] = dict(warmup_steps=5, decay_type="cosine")

  eval_pp = (f"decode|resize({arg.res})|value_range(-1, 1)"
             "|strfmt('photo number {label}', outkey='text')"
             f"|{tokenizer}|keep('image', 'labels')")
  config["evals"] = dict(
      contrastive=dict(
          type="proj.image_text.contrastive",
          data=dict(name="synthetic", n=32, num_classes=8, h=40, w=40),
          pp_fn=eval_pp, log_steps=15),
  )
  return config
