"""FlexiViT-B distilled from DeiT-III B/16 on synthetic ImageNet-1k: the
port's DeiT-III distillation path.

  python -m big_vision_torch.trainers.proj.flexi.distill \
      --config big_vision_torch/configs/proj/flexivit/i1k_deit3_distill.py:init=<deit3.npz> \
      --workdir wd
  python -m big_vision_torch.trainers.proj.flexi.distill --device cpu \
      --config big_vision_torch/configs/proj/flexivit/i1k_deit3_distill.py:runlocal,init=<deit3.npz> \
      --workdir wd

Source: big_vision_tpu/configs/proj/flexivit/i1k_deit3_distill.py
("Distill DeiT-III into FlexiViT on ImageNet-1k"). Kept as there: the
student, FlexiViT-B (width 768, depth 12, 12 heads, MLP 3072, [cls]
readout) with a stored 16x16 patch kernel and 7x7 posemb, initialised
from the DeiT-III B/16 384px checkpoint through the FlexiViT `load` (its
24x24 posemb resampled to 7x7); the teacher "prof", ViT-B/16 with a [cls]
readout at 240px, loaded from the same checkpoint through `vit.load` (its
posemb resampled 24x24 -> 15x15); 1000 classes; `softmax_xent` (the task
losses it measures); the distance "kl" with t=1; scale_by_adam with a
bf16 first moment, gradient clip 1.0, lr 1e-4, wd 1e-5, 5,000 warmup
steps then cosine, 90 epochs; the input pp
`decode_jpeg_and_inception_crop(240)|flip_lr|value_range(-1, 1)|onehot`;
the token grids seqhw (5, 6, 8, 10, 12, 15, 20, 24, 30, 40) with weights
34/43 for 15 and 1/43 for each other; f32 matmuls; a checkpoint every 1000
steps; the evals `minival_05` ... `minival_30`, classification of the
student at seqhw 5, 10, 15 and 30 (`student_seqhw=<s>`, pp
`decode|resize_small(274)|central_crop(240)|...`) every 5000 steps.

Cut, for one card and no dataset:
  * data: ImageNet-1k's `train[:99%]` (1,268,355 examples) and minival
    `train[99%:]` (12,812) are the port's synthetic JPEG source (256x320
    images, 512 unique, labels i % 1000) with those counts;
  * `deit3_B_384_1k` (the published DeiT-III checkpoint, not in the
    repository) is the path of a local `.npz` in its layout (ViT-B/16 at
    384px: a 24x24 posemb, a [cls] token, a 1000-class head), given as
    `init`: tests and `chip_smoke.py` write one with random weights;
  * batch 32 per step, one card's share of the JAX run's 1024; the evals
    take the same batch.

`CUTS` names the keys that differ from the JAX config (`RUNLOCAL_CUTS`
those of `runlocal` alone): arg, variant, input.data, input.pp,
input.batch_size, input.shuffle_buffer_size, input.prefetch,
student.attn_impl, prof.attn_impl, prof_init, student_init, evals.*.data,
evals.*.pp_fn; with `runlocal`: total_epochs, total_steps,
schedule.warmup_steps, log_training_steps, input.num_threads,
student.variant, prof.variant.

Args (`:name=value,...`): `runlocal` (the tiny version for CPU tests:
ViT-mu student and mu/16 teacher, batch 8, 3 steps, 16 images an eval
split), `init` (the DeiT-III `.npz`), `variant` ("B"), `stop` (stop after
that many steps, the schedule unchanged), `log` (steps between metric
rows), `neval` (examples in every eval split), `attn` (the attention impl
of both models: "auto", the JAX package's gate; "flash", the fused kernels
at every seqhw; or "xla", the plain path everywhere).
"""

from big_vision_torch.configs import common

CUTS = {
    "arg": "the JAX config keeps its parsed args in the config; no "
           "trainer reads them",
    "variant": "(the JAX config's parsed `variant` arg, as arg)",
    "input.data": "synthetic JPEGs in place of imagenet2012 train[:99%]",
    "input.pp": "onehot of the source's 'label'",
    "input.batch_size": "32, one card's share of 1024",
    "input.shuffle_buffer_size": "1024 raw examples",
    "input.prefetch": "4 batches",
    "student.attn_impl": "the `attn` arg (default 'auto', the JAX default)",
    "prof.attn_impl": "(as student.attn_impl)",
    "prof_init": "the `init` arg, a local .npz, in place of deit3_B_384_1k",
    "student_init": "(as prof_init)",
    "evals.*.data": "synthetic JPEGs in place of imagenet2012 train[99%:]",
    "evals.*.pp_fn": "onehot of the source's 'label'",
}
RUNLOCAL_CUTS = {
    "total_epochs": "3 steps (total_steps) on the CPU",
    "total_steps": "(as total_epochs)",
    "schedule.warmup_steps": "1, within the 3 steps",
    "log_training_steps": "a row every step",
    "input.num_threads": "2 host threads",
    "student.variant": "ViT-mu",
    "prof.variant": "mu/16",
}


def get_config(arg=None):
  arg = common.parse_arg(arg, runlocal=False, res=240, variant="B", init="",
                         stop=0, log=50, neval=0, attn="auto")
  config = {}
  config["seed"] = 0
  config["total_epochs"] = 90
  config["num_classes"] = 1000
  config["loss"] = "softmax_xent"

  config["input"] = dict(
      data=dict(name="synthetic", n=1_268_355, num_classes=1000, h=256,
                w=320, unique_images=512, encoded=True),
      batch_size=32,
      shuffle_buffer_size=1024,
      prefetch=4,
      pp=(f"decode_jpeg_and_inception_crop({arg.res})|flip_lr"
          "|value_range(-1, 1)|onehot(1000, key='label', key_result='labels')"
          "|keep('image', 'labels')"),
  )
  config["init_shapes"] = [(1, arg.res, arg.res, 3)]

  variant, prof_variant = arg.variant, f"{arg.variant}/16"
  if arg.runlocal:
    variant, prof_variant = "mu", "mu/16"
  config["student_name"] = "proj.flexi.vit"
  config["student_init"] = arg.init
  config["student"] = dict(variant=variant, pool_type="tok",
                           patch_size=(16, 16), posemb_size=(7, 7),
                           attn_impl=arg.attn)

  config["teachers"] = ["prof"]
  config["prof_name"] = "vit"
  config["prof"] = dict(variant=prof_variant, pool_type="tok",
                        attn_impl=arg.attn)
  config["prof_init"] = arg.init

  config["distance"] = "kl"
  config["distance_kw"] = dict(t=1.0)

  config["flexi"] = dict(seqhw=dict(
      v=(5, 6, 8, 10, 12, 15, 20, 24, 30, 40),
      p=(1, 1, 1, 1, 1, 34, 1, 1, 1, 1)))

  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["grad_clip_norm"] = 1.0
  config["lr"] = 1e-4
  config["wd"] = 1e-5
  config["schedule"] = dict(warmup_steps=5_000, decay_type="cosine")

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  if arg.runlocal:
    config["total_epochs"] = None
    config["total_steps"] = 3
    config["schedule"] = dict(warmup_steps=1, decay_type="cosine")
    config["input"]["batch_size"] = 8
    config["input"]["data"].update(n=64, unique_images=16)
    config["input"]["shuffle_buffer_size"] = 16
    config["input"]["num_threads"] = 2
    config["input"]["prefetch"] = 1
    config["log_training_steps"] = 1

  minival = dict(config["input"]["data"],
                 n=arg.neval or (16 if arg.runlocal else 12_812))
  config["evals"] = {}
  for s in (5, 10, 15, 30):
    config["evals"][f"minival_{s:02d}"] = dict(
        type="classification", pred=f"student_seqhw={s}", data=minival,
        pp_fn=("decode|resize_small(274)|central_crop(240)"
               "|value_range(-1, 1)"
               "|onehot(1000, key='label', key_result='labels')"
               "|keep('image', 'labels')"),
        loss_name=config["loss"], log_steps=5000)
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
