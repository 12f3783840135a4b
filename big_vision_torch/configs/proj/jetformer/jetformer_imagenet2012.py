"""JetFormer, class-conditional generation on ImageNet at 256px
(arXiv:2411.19722): port of
big_vision_tpu/configs/proj/jetformer/jetformer_imagenet2012.py.

  python -m big_vision_torch.trainers.proj.jetformer.train --workdir wd \
      --config big_vision_torch/configs/proj/jetformer/jetformer_imagenet2012.py

Kept as there: 100 epochs of `decode|resize_small(256, bicubic,
antialias)|central_crop(256)|flip_lr|value_range(-1, 1)` with the label
as a one-token text; patch_pca with `skip_pca` (16x16 patches: 256 tokens
of 768 channels, dequantization noise); the model sizes "350M" (width
1024, depth 24, MLP 4096, 16 heads, one KV head of 64, the adaptor's
blocks 4) and "1p3B"; vocab 1003 (bos, boi, nolabel), 16 vocab repeats,
128 output channels of 1024 mixtures in a bf16 head, dropout 0.1, label
drops 0.1, scan and remat; 640 channels factored out; input noise 0.3,
RGB noise 64; text first always, the loss on the suffix; the Jet adaptor
(32 channel couplings, emb 512, 8 heads, ps 1); sampling at its size's
CFG weight and temperature; Adam with b2 0.95, gradient clip 1.0, no EMA,
lr 1e-3, wd 1e-4 on the blocks' attention and MLP and every kernel, a
cosine schedule with 10% warmup (masks frozen); the mesh, FSDP strategy
and sharding rules (one "data" axis: one device here); the `mean` eval of
`validation` on train[:4096] every 1000 steps; the args `res`,
`patch_size`, `model_size`, `total_epochs`, `use_adaptor`, `runlocal`.

Cut (`CUTS`):
  * input.data, evals.val.data: no TFDS; imagenet2012's train[4096:] and
    train[:4096] are `common.stand_in`'s synthetic JPEGs of 256x320 of
    the split's size;
  * input.batch_size: BATCH, in place of the JAX run's 2048 over many
    chips: one H100 takes a step of about 1.8e12 FLOP an example
    (chip_smoke.py prints its step).

Args (`:name=value,...`), besides the JAX config's: `batch_size`, `neval`
(examples in the val split), `stop` (stop after that many steps), `log`
(steps between metric rows).
"""

from big_vision_torch.configs import common

BATCH = 32
CUTS = {
    "input.data": "no TFDS: synthetic JPEGs of 256x320, of the split's size",
    "evals.val.data": "no TFDS: synthetic JPEGs of 256x320, of the split's "
                      "size",
    "input.batch_size": f"{BATCH}: one card's step, in place of 2048 over "
                        "many chips",
}
MODELS = {
    "350M": dict(width=1024, depth=24, mlp_dim=4096, num_heads=16,
                 num_kv_heads=1, head_dim=64),
    "1p3B": dict(width=1536, depth=48, mlp_dim=6144, num_heads=16,
                 num_kv_heads=1, head_dim=96),
}
NVP_BLOCK_DEPTH = {"350M": 4, "1p3B": 6}
SAMPLING = {"350M": (3, 0.94), "1p3B": (2, 0.93)}  # (cfg_w, temp)


def get_config(arg=None):
  arg = common.parse_arg(arg, res=256, patch_size=16, model_size="350M",
                         total_epochs=100, use_adaptor=True, runlocal=False,
                         batch_size=BATCH, neval=0, stop=0, log=50)
  c = {}
  c["seed"] = 0
  c["total_epochs"] = arg.total_epochs

  c["input"] = dict(
      data=common.stand_in("imagenet2012", "train[4096:]"),
      batch_size=arg.batch_size if not arg.runlocal else 8,
      shuffle_buffer_size=25_000 if not arg.runlocal else 10,
      pp=(f"decode|resize_small({arg.res}, method='bicubic',"
          " antialias=True)"
          f"|central_crop({arg.res})|flip_lr"
          "|value_range(-1, 1, key='image')"
          "|reshape((1,), inkey='label', outkey='text')"
          "|setdefault('text_loss', [1])"
          "|copy('text_loss', 'text_mask')"
          "|keep('image', 'text', 'text_mask', 'text_loss')"),
  )
  c["init_shapes"] = [(1, arg.res, arg.res, 3), (1, 1)]
  c["log_training_steps"] = arg.log
  c["ckpt_steps"] = 1000

  seq_len = (arg.res // arg.patch_size) ** 2
  subpix = arg.patch_size ** 2 * 3

  cfg_w, temp = SAMPLING[arg.model_size]
  c["sample_images"] = dict(cfg_inference_weight=cfg_w, temperature=temp,
                            temperature_probs=1.0)
  c["decode_len"] = seq_len

  c["patch_pca"] = dict(
      model_name="proj.jetformer.patch_pca",
      model=dict(depth_to_seq=1, input_size=(arg.res, arg.res),
                 patch_size=(arg.patch_size, arg.patch_size),
                 code_len=seq_len, codeword_dim=subpix, noise_std=0.0,
                 add_dequant_noise=True, skip_pca=True))

  num_labels = 1000
  c["model_name"] = "proj.jetformer.jetformer"
  c["model"] = dict(MODELS[arg.model_size])
  c["model"].update(
      bos_id=num_labels, boi_id=num_labels + 1, nolabel_id=num_labels + 2,
      vocab_size=num_labels + 3, out_dim=128, num_mixtures=1024,
      dropout=0.1, drop_labels_probability=0.1, head_dtype="bfloat16",
      scan=True, remat_policy="nothing_saveable", num_vocab_repeats=16)

  c["input_noise_std"] = 0.3
  c["noise_scale"] = 64.0  # the RGB-noise cosine curriculum
  c["latent_noise_dim"] = subpix - c["model"]["out_dim"]
  c["text_prefix_prob"] = 1.0
  c["loss_on_prefix"] = False

  c["adaptor_name"] = "proj.jet.jet" if arg.use_adaptor else ""
  c["adaptor"] = dict(model=dict(
      depth=32, block_depth=NVP_BLOCK_DEPTH[arg.model_size],
      emb_dim=512, num_heads=8, ps=1,
      kinds=("channels",),
      channels_coupling_projs=("random",),
      spatial_coupling_projs=("checkerboard", "checkerboard-inv")))

  c["optax_name"] = "scale_by_adam"
  c["optax"] = dict(b2=0.95)
  c["grad_clip_norm"] = 1.0
  c["ema_decay"] = 0.0
  c["lr"] = 0.001
  c["wd"] = 0.0001
  c["wd_mults"] = [
      ("^decoder/layers/attn/.*", 1.0),
      ("^decoder/layers/mlp/.*", 1.0),
      (".*/kernel$", 1.0),
  ]
  c["schedule"] = [
      (".*FREEZE_ME.*", None),
      (".*", dict(decay_type="cosine", warmup_percent=0.1)),
  ]
  c["mesh"] = [("data", -1)]
  c["sharding_strategy"] = [
      (".*FREEZE_ME.*", "replicate"),
      (".*", 'fsdp(axis="data")'),
  ]
  c["sharding_rules"] = [("act_batch", ("data",))]

  c["evals"] = {}
  c["evals"]["val"] = dict(
      type="mean", pred="validation",
      data=common.stand_in("imagenet2012", "train[:4096]", n=arg.neval),
      pp_fn=c["input"]["pp"].replace("|flip_lr", ""),
      log_steps=1000)
  if arg.stop:
    c["stop_after_steps"] = arg.stop
  return c
