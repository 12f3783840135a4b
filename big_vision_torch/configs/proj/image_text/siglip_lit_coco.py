"""LiT on COCO captions with the sigmoid loss (a frozen ViT-B/16 image tower
and a trained BERT-base text tower): port of
big_vision_tpu/configs/proj/image_text/siglip_lit_coco.py.

  python -m big_vision_torch.trainers.proj.image_text.siglip --workdir wd \
      --config big_vision_torch/configs/proj/image_text/siglip_lit_coco.py:img_init=<img.npz>,txt_init=<txt.npz>

Kept as there: the image pp `decode|resize(224)|flip_lr|value_range(-1,
1)` then `flatten|choice` of one caption and `bert_tokenize` to 16 tokens
(so the whole pp runs on the host: `bert_tokenize` is host-only, as in the
JAX package), 5,000 steps, the two towers (ViT-B/16 with `tok` pooling and
no head, out_dim (0, 768); BERT "base" with a 768 head; t = 10, b = -2.71
at init), `model_load` without the heads, the image tower frozen (the
schedule `.*img/.*` None) and the rest with 150 warmup steps then cosine,
Adam with lr 1e-3, wd 0.01, gradient clip 1.0, metric rows every 50 steps,
a checkpoint every 1000, the retrieval eval every 1000 steps in its
`pp_img`, `pp_txt`, `txt_name` form; the args `res`, `runlocal`,
`variant`, `init`, `img_head` and `batch_size`.

Cut (`CUTS`):
  * input.data, evals.retrieval_coco.data: no TFDS; COCO captions'
    Karpathy splits (train 82,783, val 5,000 images) are
    `common.stand_in`'s synthetic JPEGs of 256x320 with "image/id" and five
    captions an image drawn from its label;
  * input.pp, evals.retrieval_coco.pp_txt: the vocabulary is the
    stand-in `vocab.txt` of BERT's 30,522 rows written by
    `proj.image_text.common.stand_in_vocab` (at the `vocab` arg,
    build/siglip/vocab.txt by default): the published BERT vocabulary is
    not in the repository;
  * model_init: the published inits (`howto-i21k-B/16`, `bert_base`)
    cannot be fetched. With the args `img_init` and `txt_init` (`.npz`
    files of a ViT-B/16 and a BERT-base, e.g. random weights from a seed)
    the config reads them as the JAX config reads the published ones;
    without, the towers start from the seed;
  * input.batch_size: 256, the largest power of two at which the step,
    with the frozen tower's gradients (`l2_grads` covers them, as in JAX),
    fits in one H100's 80 GB (512 runs out of memory; `chip_smoke.py
    --siglip` measures both).

Args (`:name=value,...`), besides the JAX config's: `vocab`, `img_init`,
`txt_init`, `neval` (images in the val split; its captions are five
times as many), `stop` (stop after that many steps), `log` (steps
between metric rows), `attn` (the image tower's attention impl, when not
"auto"), `ckpt` (steps between checkpoints), `eval_every` (steps
between retrieval evals), and `zeroshot` (0: none): the zero-shot
`proj.image_text.discriminative_classifier` eval `zeroshot_i1k`, the 81
CLIP-paper prompt templates over the 1000 CLIP ImageNet class names
tokenized as the captions are, on that many images of the imagenet2012
validation stand-in in batches of 64; no JAX config sets it.
"""

from big_vision_torch.configs import common as bvcc
from big_vision_torch.configs.proj.image_text import common

CUTS = {
    "input.data": "no TFDS: coco_captions train is synthetic JPEGs with "
                  "five captions an image, of the split's size",
    "evals.retrieval_coco.data": "no TFDS: coco_captions val is synthetic "
                                 "JPEGs with five captions an image",
    "input.pp": "the stand-in vocab.txt, written in place",
    "evals.retrieval_coco.pp_txt": "the stand-in vocab.txt, written in place",
    "model_init": "the published inits cannot be fetched: img_init and "
                  "txt_init name .npz files",
    "input.batch_size": "256: the largest power of two that fits on one "
                        "80 GB card with the image tower's gradients",
}


def get_config(arg=None):
  arg = bvcc.parse_arg(arg, res=224, runlocal=False, variant="B", init="",
                       img_head=False, batch_size=256,
                       vocab="build/siglip/vocab.txt", img_init="",
                       txt_init="", neval=0, stop=0, log=50, attn="auto",
                       ckpt=1000, eval_every=1000, zeroshot=0)
  txt_name, txt_init, img_name, img_init = common.inits(arg.variant)
  del txt_init, img_init  # the published inits: not in reach
  vocab = common.stand_in_vocab(arg.vocab)
  config = {}
  config["seed"] = 0

  text_len = 16
  config["input"] = dict(
      data=bvcc.stand_in("coco_captions", "train"),
      batch_size=arg.batch_size if not arg.runlocal else 32,
      shuffle_buffer_size=250_000 if not arg.runlocal else 50,
      pp=(f"decode|resize({arg.res})|flip_lr|value_range(-1, 1)"
          "|flatten|choice(inkey='captions/text', outkey='text')"
          f"|bert_tokenize('{vocab}', {text_len}, inkey='text')"
          "|keep('image', 'labels')"),
  )
  config["total_steps"] = 5_000 if not arg.runlocal else 1
  config["pp_modules"] = ["ops_general", "ops_image", "ops_text",
                          "proj.flaxformer.bert_ops"]
  config["init_shapes"] = [(1, arg.res, arg.res, 3), (1, text_len)]
  config["init_types"] = ["float32", "int32"]

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = arg.ckpt
  config["loss_use_global_batch"] = True

  config["model_name"] = "proj.image_text.two_towers"
  config["model_load"] = {}
  if arg.init:
    config["model_init"] = arg.init
  else:
    if arg.img_init and arg.txt_init:
      config["model_init"] = {"image": arg.img_init, "text": arg.txt_init}
    config["model_load"]["txt_load_kw"] = {"dont_load": ["head/.*"]}
    if not arg.img_head:
      config["model_load"]["img_load_kw"] = {"dont_load": ["head/.*"]}
  config["model"] = dict(
      image_model="vit",
      text_model="proj.flaxformer.bert",
      image=dict(variant=img_name, pool_type="tok", head_zeroinit=False),
      text=dict(config=txt_name, head_zeroinit=False),
      temperature_init=10.0, bias_init=-2.71,
      out_dim=(0, 768))
  if arg.attn != "auto":
    config["model"]["image"]["attn_impl"] = arg.attn

  # LiT: freeze the image tower, tune the text tower.
  config["schedule"] = [
      (".*img/.*", None),
      (".*", dict(warmup_steps=max(int(0.03 * 5000), 100),
                  decay_type="cosine")),
  ]
  config["optax_name"] = "scale_by_adam"
  config["lr"] = 0.001
  config["wd"] = 0.01
  config["grad_clip_norm"] = 1.0

  config["evals"] = {}
  config["evals"]["retrieval_coco"] = dict(
      type="proj.image_text.retrieval",
      data=bvcc.stand_in("coco_captions", "val", n=arg.neval),
      log_steps=arg.eval_every,
      pp_img=f"resize({arg.res})|value_range(-1, 1)",
      pp_txt=f"bert_tokenize('{vocab}', {text_len}, inkey='text')",
      txt_name=("captions", "text"))
  if arg.zeroshot:
    config["evals"]["zeroshot_i1k"] = dict(
        type="proj.image_text.discriminative_classifier",
        data=bvcc.stand_in("imagenet2012", "validation", n=arg.zeroshot),
        pp_fn=(f"decode|resize({arg.res})|value_range(-1, 1)"
               "|keep('image', 'label')"),
        pp_txt=f"bert_tokenize('{vocab}', {text_len}, inkey='text')",
        prompt_templates="clip_paper", batch_size=64,
        log_steps=arg.eval_every)
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
