"""CapPa smoke config (a tiny captioner on synthetic captions): port of
big_vision_tpu/configs/proj/cappa/smoke.py.

  python -m big_vision_torch.trainers.proj.cappa.generative --device cpu \
      --config big_vision_torch/configs/proj/cappa/smoke.py --workdir wd

Kept as there, all of it: 64 synthetic JPEGs of 24x24 in 8 classes,
resized to 16px, each captioned "photo number {label}" and tokenized by
the `test(64)` tokenizer to 8 tokens (eos, PAD 0); a CapPa of width 32
(2 heads, 2 encoder and 2 decoder layers, MLP 64, 8x8 patches, learned
posembs, vocab 64) with `masked_pred_prob` 0.5 and `masking_ratio` 0.5;
Adam with lr 1e-3, wd 0, 2 warmup steps then cosine; batch 16, 15 steps,
metric rows every 5 steps, a checkpoint every 10, the perplexity eval on
16 examples every 10 steps; the args `res`, `total_steps` and
`batch_size`.

Nothing is cut (`CUTS` is empty).
"""

from big_vision_torch.configs import common

CUTS = {}


def get_config(arg=None):
  arg = common.parse_arg(arg, res=16, total_steps=15, batch_size=16)
  config = {}
  config["seed"] = 0
  config["total_steps"] = arg.total_steps
  config["init_shapes"] = [(1, arg.res, arg.res, 3), (1, 8)]

  config["input"] = dict(
      data=dict(name="synthetic", n=64, num_classes=8, h=24, w=24),
      batch_size=arg.batch_size,
      shuffle_buffer_size=32, num_threads=4, prefetch=1,
      pp=(f"decode|resize({arg.res})|value_range(-1, 1)"
          "|strfmt('photo number {label}', outkey='text')"
          "|tokenize(8, eos='yes', model='test(64)', pad_value=0,"
          " inkey='text', outkey='labels')"
          "|keep('image', 'labels')"),
  )
  config["log_training_steps"] = 5
  config["ckpt_steps"] = 10

  config["model_name"] = "proj.cappa.cappa"
  config["model"] = dict(
      num_heads=2, num_layers=2, mlp_dim=64, emb_dim=32,
      vocab_size=64, seq_len=8, patches=(8, 8),
      posemb_type="learn",
      masked_pred_prob=0.5, masking_ratio=0.5,
  )

  config["optax_name"] = "scale_by_adam"
  config["lr"] = 1e-3
  config["wd"] = 0.0
  config["schedule"] = dict(warmup_steps=2, decay_type="cosine")

  config["evals"] = dict(
      perplexity=dict(
          type="proj.cappa.perplexity", pred="perplexity",
          data=dict(name="synthetic", n=16, num_classes=8, h=24, w=24),
          pp_fn=config["input"]["pp"], log_steps=10),
  )
  return config
