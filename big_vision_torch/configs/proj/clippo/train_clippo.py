"""CLIPPO: contrastive training of one tower on images and on their
captions rendered as images (arXiv:2212.08045): port of
big_vision_tpu/configs/proj/clippo/train_clippo.py.

  python -m big_vision_torch.trainers.proj.image_text.siglip --workdir wd \
      --config big_vision_torch/configs/proj/clippo/train_clippo.py

Kept as there: 224px images (`decode|resize|flip_lr|value_range(-1, 1)`)
and one caption of each drawn by `flatten|choice`, rendered by
`render_unifont` into a 224px image under "labels" (the SigLIP trainer
calls model(image, labels)) and scaled to [-1, 1]; CLIPPO's one tower, a
ViT-B/16 with MAP pooling and a 768-wide head, t = 10 at init; the SigLIP
trainer's sigmoid loss; Adam with lr 1e-4, wd 3e-4, gradient clip 1.0, the
rsqrt schedule (timescale 5,000), 400 steps; metric rows every 50 steps, a checkpoint every 1000, the
retrieval eval every 1000 steps in its `pp_img`, `pp_txt`, `txt_name`
form; the args `res`, `runlocal` and `variant`. The JAX config names no
Unifont table, so both packages render with PIL's default font (the op's
fallback); GNU Unifont's `.hex` tables are not in the repository.

Cut (`CUTS`):
  * input.data, evals.retrieval_coco.data: no TFDS; COCO captions'
    Karpathy splits (train 82,783, val 5,000 images) are
    `common.stand_in`'s synthetic JPEGs of 256x320 with five captions an
    image;
  * evals.retrieval_coco.pp_txt: `render_unifont` reads the caption at
    'text', the key under which the retrieval evaluator hands out each
    caption (`txt_name[-1]`); the JAX op's default, 'texts', is absent
    there;
  * model_init: the published `howto-i21k-B/16` cannot be fetched; the
    tower starts from the seed, or from the `init` arg (an `.npz` of a
    CLIPPO model with `img` and `t`);
  * input.batch_size: 256 of 4000, the largest power of two at which an
    update (two passes of the tower) fits in one H100's 80 GB
    (`chip_smoke.py --imagetext` tries twice the batch);
  * schedule.warmup_steps, schedule.cooldown_steps: 40 each, a tenth of
    the 400 steps. The JAX config's 5,000 each exceed its 400 total
    steps, which both packages' schedules refuse ("warmup >=
    total_steps"), so the JAX config cannot train as written.

Args (`:name=value,...`), besides the JAX config's: `init`, `batch_size`,
`neval` (images in the val split), `stop` (stop after that many steps),
`log` (steps between metric rows) and `eval_every` (steps between
retrieval evals).
"""

from big_vision_torch.configs import common as bvcc

CUTS = {
    "input.data": "no TFDS: coco_captions train is synthetic JPEGs with "
                  "five captions an image, of the split's size",
    "evals.retrieval_coco.data": "no TFDS: coco_captions val is synthetic "
                                 "JPEGs with five captions an image",
    "evals.retrieval_coco.pp_txt": "render_unifont reads the rows' 'text'",
    "model_init": "the published init cannot be fetched: the seed, or the "
                  "init arg's .npz",
    "input.batch_size": "256: the largest power of two that fits on one "
                        "80 GB card",
    "schedule.warmup_steps": "40: the JAX config's 5,000 exceed its 400 "
                             "steps, which the schedule refuses",
    "schedule.cooldown_steps": "40, as the warmup",
}


def get_config(arg=None):
  arg = bvcc.parse_arg(arg, res=224, runlocal=False, variant="B/16",
                       init="", batch_size=256, neval=0, stop=0, log=50,
                       eval_every=1000)
  config = {}
  config["seed"] = 0

  config["input"] = dict(
      data=bvcc.stand_in("coco_captions", "train"),
      batch_size=arg.batch_size if not arg.runlocal else 32,
      shuffle_buffer_size=250_000 if not arg.runlocal else 50,
      # The rendered-text image rides in "labels": the SigLIP trainer
      # calls model(batch["image"], batch["labels"]).
      pp=(f"decode|resize({arg.res})|flip_lr|value_range(-1, 1)"
          "|flatten|choice(inkey='captions/text', outkey='texts')"
          f"|render_unifont({arg.res}, outkey='labels')"
          "|value_range(-1, 1, inkey='labels', outkey='labels')"
          "|keep('image', 'labels')"),
  )
  config["total_steps"] = 400 if not arg.runlocal else 10
  config["pp_modules"] = ["ops_general", "ops_image", "ops_text",
                          "proj.clippo.pp_ops"]
  config["init_shapes"] = [(1, arg.res, arg.res, 3),
                           (1, arg.res, arg.res, 3)]

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000
  config["loss_use_global_batch"] = True

  config["model_name"] = "proj.clippo.one_tower"
  config["model"] = dict(
      image=dict(variant=arg.variant, pool_type="map"),
      temperature_init=10.0, out_dim=768)
  if arg.init:
    config["model_init"] = arg.init

  config["optax_name"] = "scale_by_adam"
  config["lr"] = 1e-4
  config["wd"] = 3e-4
  config["schedule"] = dict(
      decay_type="rsqrt", timescale=5_000,
      warmup_steps=40 if not arg.runlocal else 5,
      cooldown_steps=40 if not arg.runlocal else 5)
  config["grad_clip_norm"] = 1.0

  config["evals"] = {}
  config["evals"]["retrieval_coco"] = dict(
      type="proj.image_text.retrieval",
      data=bvcc.stand_in("coco_captions", "val", n=arg.neval),
      log_steps=arg.eval_every,
      pp_img=f"resize({arg.res})|value_range(-1, 1)",
      pp_txt=(f"render_unifont({arg.res}, inkey='text', outkey='labels')"
              "|value_range(-1, 1, inkey='labels', outkey='labels')"),
      txt_name=("captions", "text"))
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
