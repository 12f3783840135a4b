"""PaliGemma smoke config (a tiny ViT and a tiny Gemma on synthetic
captions): port of big_vision_tpu/configs/proj/paligemma/smoke.py.

  python -m big_vision_torch.trainers.proj.paligemma.train --device cpu \
      --config big_vision_torch/configs/proj/paligemma/smoke.py \
      --workdir <dir>

Exercises the image and text pp (tok, masked_concat, tolen), prefix-LM
masking, the masked next-token CE, the perplexity evaluator, remat of the
LLM's blocks, and with `:attn=flash` the LLM's fused attention on `seg`.
The JAX config's keys, values and args, unchanged (`CUTS` is empty); the
args `seq_mesh` (a mesh with a "seq" axis) is refused by the port's
trainer, which runs on one device.
"""

from big_vision_torch.configs import common as bvcc

CUTS = {}


def get_config(arg=None):
  arg = bvcc.parse_arg(arg, res=16, total_steps=20, batch_size=16,
                       attn="auto", seq_mesh=0, log=5, ckpt=10, stop=0)
  config = {}

  config["seed"] = 0
  config["total_steps"] = arg.total_steps
  config["init_shapes"] = [(1, arg.res, arg.res, 3), (1, 12)]

  if arg.seq_mesh:  # context parallelism over the LLM token axis
    config["mesh"] = [("data", -1), ("seq", arg.seq_mesh)]
    config["sharding_rules"] = [("act_batch", "data"), ("act_emb", None),
                                ("act_len", "seq")]

  tok = "model='test(256)'"
  pp = (
      f"decode|resize({arg.res})|value_range(-1, 1)"
      "|strfmt('item number {label}', outkey='suffix_text')"
      f"|tok({tok}, text='describe the image', bos='yes', outkey='prefix')"
      f"|tok({tok}, inkey='suffix_text', outkey='suffix', eos='yes')"
      "|masked_concat(['prefix', 'suffix'], mask_ar=[0, 1], mask_loss=[0, 1])"
      "|tolen(12, pad_value=0, key='text')"
      "|tolen(12, pad_value=0, key='mask_ar')"
      "|tolen(12, pad_value=0, key='mask_loss')"
      "|keep('image', 'text', 'mask_ar', 'mask_loss')")

  config["input"] = dict(
      data=dict(name="synthetic", n=64, num_classes=8, h=24, w=24),
      batch_size=arg.batch_size,
      shuffle_buffer_size=32,
      num_threads=4,
      prefetch=1,
      pp=pp,
  )

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = arg.ckpt
  if arg.stop:
    config["stop_after_steps"] = arg.stop

  config["model_name"] = "proj.paligemma.paligemma"
  config["model"] = dict(
      img=dict(variant="mu/16", pool_type="none", posemb="sincos2d",
               head_zeroinit=False),
      llm=dict(variant="gemma_test", scan=True, cache_dtype=None,
               attn_impl=arg.attn),
  )

  config["optax_name"] = "scale_by_adam"
  config["lr"] = 1e-3
  config["wd"] = 0.0
  config["schedule"] = dict(warmup_steps=2, decay_type="cosine")
  config["decode"] = dict(max_decode_len=6, eos_token=1)

  config["evals"] = dict(
      perplexity=dict(
          type="proj.paligemma.perplexity", pred="perplexity",
          data=dict(name="synthetic", n=16, num_classes=8, h=24, w=24),
          pp_fn=pp, log_steps=10),
  )
  return config
