"""PaliGemma transfer to COCO captions: port of
big_vision_tpu/configs/proj/paligemma/transfers/cococap.py.

  python -m big_vision_torch.trainers.proj.paligemma.train --workdir wd \
      --config big_vision_torch/configs/proj/paligemma/transfers/cococap.py

Kept as there: PaliGemma-3B (So400m/14 at 224px, 256 image tokens, scan
and so remat; gemma_2b with the vocab of 257,152, remat, dropout 0), the
training pp (`flatten`, decode, `resize(224)`, value_range(-1, 1), one
caption drawn by `choice_no_replacement` as the suffix of the prompt
"caption en", 32 + 1 text tokens: the LLM sees T = 289), 5 epochs of
`train[:98%]+restval`, Adam with b2 0.999, lr 1e-5, wd 1e-6, gradient
clip 1.0, cosine schedule with 5% warmup, the `coco_caption` beam-decode
evals (CIDEr) and the perplexity evals on the minitrain `train[:2%]`,
minival `train[-2%:]` and eval `val` splits, and the JAX config's args
(`mode`, `crop`, `res`, `final_split`). The JAX trainer could not run it
as it stands: it reads `config.init_shapes`, which this config does not
set; the port's trainer takes the image size from the pipeline.

Cut (`CUTS`):
  * input.data, evals.*.data: no TFDS; each coco_captions split is
    `common.stand_in`'s synthetic JPEGs of 256x320 with five captions an
    image, of the split's TFDS size (`configs/common.SPLITS`), or `neval`
    examples an eval split (the eval split sizes);
  * input.pp, evals.*.pp_fn, evals.*.tokenizer: Gemma's SentencePiece
    model becomes the stand-in of `transfers.common.stand_in_tokenizer`
    (256,000 pieces that cover the stand-in captions and the prompt),
    written in place at the `vocab` arg;
  * model_init: "pt_224", the published checkpoint, cannot be fetched:
    the weights are drawn from the seed (or read from the `init` arg, an
    `.npz` with img and llm subtrees);
  * input.batch_size: 256 becomes 64. The f32 step (2.9e9 params, their
    gradients and Adam's two moments: 46.8 GB before any activation)
    peaks at 55.6 GiB at 64 on one H100 (79.2 GiB); one update at 128
    peaks at 68.5 GiB, but in one process a seventh update at 128 ran out
    of memory with 12.5 GiB held by the allocator's fragments, and 256
    does not fit: 64 is the largest power of two that trains with margin
    (`chip_smoke.py --paligemma` tries one update at 128).

Args besides the JAX config's (`transfers/common.PORT_ARGS`): `vocab`,
`batch_size`, `neval`, `stop`, `log`, `ckpt`, `attn` (the LLM's
attn_impl: "flash" runs its attention on the fused kernels with `seg`)
and `init`.
"""

from big_vision_torch.configs.proj.paligemma.transfers import common as c7n

CUTS = {
    "input.data": "no TFDS: coco_captions splits are synthetic JPEGs with "
                  "five captions an image, of the split's size",
    "evals.*.data": "no TFDS: synthetic JPEGs with five captions an image, "
                    "of the split's size or neval",
    "input.pp": "the stand-in Gemma tokenizer, written in place",
    "evals.*.pp_fn": "the stand-in Gemma tokenizer, written in place",
    "evals.*.tokenizer": "the stand-in Gemma tokenizer, written in place",
    "model_init": "the published pt_224 checkpoint cannot be fetched: the "
                  "weights are drawn from the seed",
    "input.batch_size": "64: the largest power of two whose f32 steps "
                        "fit one 80 GB card with margin",
}


def get_config(arg=None):
  return c7n.caption_task_config(
      arg, data_name="coco_captions",
      suffix_pp=("choice_no_replacement(inkey='captions/text',"
                 " outkey='suffix')"),
      pp_before=("flatten",),
      train_split="train[:98%]+restval",
      final_train_split="train+restval",
      eval_splits=[("minitrain", "train[:2%]"),
                   ("minival", "train[-2%:]"), ("eval", "val")],
      captions_pp=("flatten", "copy('captions/text', 'captions')"),
      total_epochs=5, lr=1e-5, wd=1e-6, prefix_name="cococap")
