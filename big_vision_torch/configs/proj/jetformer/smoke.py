"""JetFormer smoke config (a tiny class-conditional model on synthetic
JPEGs): port of big_vision_tpu/configs/proj/jetformer/smoke.py.

  python -m big_vision_torch.trainers.proj.jetformer.train --device cpu \
      --config big_vision_torch/configs/proj/jetformer/smoke.py --workdir wd

Kept as there, all of it: 32 synthetic JPEGs of 24x24 (8 classes) through
`decode|resize(16)|value_range(-1, 1)`, the label as a one-token text with
`text_loss` and `text_mask` 1; batch 8, 4 steps, metric rows every 2
steps, no checkpoints; patch_pca with `skip_pca` (4x4 patches, 16 tokens
of 48 channels, dequantization noise); JetFormer (width 32, depth 2, MLP
64, 2 heads, 1 KV head of 16, scan, vocab 11 with bos, boi and nolabel,
16 output channels, 4 mixtures, 2 vocab repeats, label drops 0.1); the
last 32 channels factored out; input noise 0.1, RGB noise 8; text first
always, the loss on the suffix; the Jet adaptor (2 channel couplings of
one block, emb 32, 2 heads, ps 1); sampling at CFG weight 0; Adam with b2
0.95, gradient clip 1.0, EMA 0.99, lr 1e-3, wd 1e-4, a cosine schedule
with 10% warmup (masks frozen); the `mean` eval of `validation` on 16
images at step 4; the args `res`, `patch_size`, `total_steps`,
`batch_size` and `use_adaptor`.

Nothing is cut (`CUTS` is empty).
"""

from big_vision_torch.configs import common

CUTS = {}


def get_config(arg=None):
  arg = common.parse_arg(arg, res=16, patch_size=4, total_steps=4,
                         batch_size=8, use_adaptor=True)
  config = {}
  config["seed"] = 0
  config["total_steps"] = arg.total_steps

  num_labels = 8
  config["input"] = dict(
      data=dict(name="synthetic", n=32, num_classes=num_labels, h=24, w=24),
      batch_size=arg.batch_size,
      shuffle_buffer_size=32, num_threads=4, prefetch=1,
      pp=(f"decode|resize({arg.res})|value_range(-1, 1)"
          "|reshape((1,), inkey='label', outkey='text')"
          "|setdefault('text_loss', [1])"
          "|copy('text_loss', 'text_mask')"
          "|keep('image', 'text', 'text_mask', 'text_loss')"),
  )
  config["init_shapes"] = [(1, arg.res, arg.res, 3), (1, 1)]
  config["log_training_steps"] = 2
  config["ckpt_steps"] = None

  seq_len = (arg.res // arg.patch_size) ** 2
  subpixels_per_patch = arg.patch_size * arg.patch_size * 3

  config["patch_pca"] = dict(
      model_name="proj.jetformer.patch_pca",
      model=dict(input_size=(arg.res, arg.res),
                 patch_size=(arg.patch_size, arg.patch_size),
                 code_len=seq_len, codeword_dim=subpixels_per_patch,
                 noise_std=0.0, add_dequant_noise=True, skip_pca=True))

  config["model_name"] = "proj.jetformer.jetformer"
  config["model"] = dict(
      width=32, depth=2, mlp_dim=64, num_heads=2, num_kv_heads=1,
      head_dim=16,
      bos_id=num_labels, boi_id=num_labels + 1, nolabel_id=num_labels + 2,
      vocab_size=num_labels + 3,
      out_dim=16, num_mixtures=4, dropout=0.0,
      drop_labels_probability=0.1, num_vocab_repeats=2, scan=True,
      remat_policy="none")
  config["latent_noise_dim"] = subpixels_per_patch - config["model"]["out_dim"]

  config["input_noise_std"] = 0.1
  config["noise_scale"] = 8.0
  config["text_prefix_prob"] = 1.0
  config["loss_on_prefix"] = False

  config["adaptor_name"] = "proj.jet.jet" if arg.use_adaptor else ""
  config["adaptor"] = dict(model=dict(
      depth=2, block_depth=1, emb_dim=32, num_heads=2, ps=1,
      kinds=("channels",), channels_coupling_projs=("random",),
      spatial_coupling_projs=("checkerboard", "checkerboard-inv")))

  config["sample_images"] = dict(cfg_inference_weight=0.0, temperature=1.0,
                                 temperature_probs=1.0)
  config["decode_len"] = seq_len

  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(b2=0.95)
  config["grad_clip_norm"] = 1.0
  config["ema_decay"] = 0.99
  config["lr"] = 1e-3
  config["wd"] = 1e-4
  config["schedule"] = [
      (".*FREEZE_ME.*", None),
      (".*", dict(decay_type="cosine", warmup_percent=0.1)),
  ]

  config["evals"] = {}
  config["evals"]["val"] = dict(
      type="mean", pred="validation",
      data=dict(name="synthetic", n=16, num_classes=num_labels, h=24, w=24),
      pp_fn=config["input"]["pp"], log_steps=4)
  return config
