"""FlexiViT-B distilled from a ViT-B/8 teacher on synthetic images: the
port's FlexiViT distillation path.

  python -m big_vision_torch.trainers.proj.flexi.distill \
      --config big_vision_torch/configs/proj/flexivit/i21k_distill.py:prof_init=<teacher.npz> \
      --workdir wd
  python -m big_vision_torch.trainers.proj.flexi.distill --device cpu \
      --config big_vision_torch/configs/proj/flexivit/i21k_distill.py:runlocal \
      --workdir wd

Source: big_vision_tpu/configs/proj/flexivit/i21k_distill.py ("Distill a
fixed ViT teacher into FlexiViT on ImageNet-21k"). Kept as there: the
student, FlexiViT-B (width 768, depth 12, 12 heads, MLP 3072, stored 32x32
patch kernel, learned 7x7 posemb, [cls] readout), trained from scratch
(`student_init` empty); one teacher "prof", ViT-B/8 with a [cls] readout
at 240px (T = 901); 21843 classes; `softmax_xent` (the task losses it
measures); the distance "kl" with t=1; scale_by_adam with a bf16 first
moment, gradient clip 1.0, lr 1e-3, wd 1e-4, 5,000 warmup steps then
cosine, 90 epochs; the token grids seqhw (5, 6, 8, 10, 12, 15, 20, 24, 30,
40) with weights 34/43 for 15 and 1/43 for each other; f32 matmuls (the
JAX config sets no dtype_mm); a checkpoint every 1000 steps; no evaluators.

Cut, for one card and no dataset:
  * batch 32 per step, one card's share of the JAX run's 4096 over 128
    chips;
  * data: the port's synthetic source (16,384 raw 256x320 images, 512
    unique, labels i % 21843) with `random_crop(240)` in place of
    ImageNet-21k's `decode_jpeg_and_inception_crop(240)` (the port has
    the JPEG decode now; this config keeps raw images); an epoch is the
    source's 16,384 examples;
  * `prof_init`: the path of a local `.npz` in the layout of the published
    "howto-i21k-B/8" checkpoint (which is not in the repository) instead of
    that name; empty by default, which leaves the teacher at its random
    init.

`CUTS` names the keys that differ from the JAX config (`RUNLOCAL_CUTS`
those of `runlocal` alone): arg, input.data, input.pp, input.batch_size,
input.shuffle_buffer_size, input.prefetch, student.attn_impl,
prof.attn_impl, prof_init; with `runlocal`: total_epochs, total_steps,
schedule.warmup_steps, log_training_steps, input.num_threads,
student.variant, prof.variant.

Args (`:name=value,...`): `runlocal` (the tiny version for CPU tests:
ViT-mu student and mu/8 teacher, batch 8, 3 steps), `prof_init` (the
teacher's `.npz`), `stop` (stop after that many steps, the schedule
unchanged), `log` (steps between metric rows), `ckpt` (steps between
checkpoints), `attn` (the attention impl of both models: "auto", the JAX
package's gate, which at batch 32 takes the plain path at T = 901 and 1601,
the teacher's included; "flash", the fused kernels at every seqhw; or "xla",
the plain path everywhere).
"""

from big_vision_torch.configs import common

CUTS = {
    "arg": "the JAX config keeps its parsed args in the config; no "
           "trainer reads them",
    "input.data": "synthetic raw images in place of imagenet21k",
    "input.pp": "random_crop(240) of raw images in place of the JPEG "
                "decode and inception crop; onehot of the source's 'label'",
    "input.batch_size": "32, one card's share of 4096",
    "input.shuffle_buffer_size": "1024 raw examples",
    "input.prefetch": "4 batches",
    "student.attn_impl": "the `attn` arg (default 'auto', the JAX default)",
    "prof.attn_impl": "(as student.attn_impl)",
    "prof_init": "a local .npz in place of howto-i21k-B/8",
}
RUNLOCAL_CUTS = {
    "total_epochs": "3 steps (total_steps) on the CPU",
    "total_steps": "(as total_epochs)",
    "schedule.warmup_steps": "1, within the 3 steps",
    "log_training_steps": "a row every step",
    "input.num_threads": "2 host threads",
    "student.variant": "ViT-mu",
    "prof.variant": "mu/8",
}


def get_config(arg=None):
  arg = common.parse_arg(arg, runlocal=False, res=240, prof_init="", stop=0,
                         log=50, ckpt=1000, attn="auto")
  config = {}
  config["seed"] = 0
  config["total_epochs"] = 90
  config["num_classes"] = 21843
  config["loss"] = "softmax_xent"
  config["input"] = dict(
      data=dict(name="synthetic", n=16384, num_classes=21843, h=256, w=320,
                unique_images=512, encoded=False),
      batch_size=32,
      shuffle_buffer_size=1024,
      prefetch=4,
      pp=(f"random_crop({arg.res})|flip_lr|value_range(-1, 1)"
          "|onehot(21843, key='label', key_result='labels')"
          "|keep('image', 'labels')"),
  )
  config["init_shapes"] = [(1, arg.res, arg.res, 3)]
  config["log_training_steps"] = arg.log

  config["student_name"] = "proj.flexi.vit"
  config["student"] = dict(variant="B", pool_type="tok", patch_size=(32, 32),
                           posemb_size=(7, 7), attn_impl=arg.attn)
  config["student_init"] = ""

  config["teachers"] = ["prof"]
  config["prof_name"] = "vit"
  config["prof"] = dict(variant="B/8", pool_type="tok", attn_impl=arg.attn)
  config["prof_init"] = arg.prof_init

  config["distance"] = "kl"
  config["distance_kw"] = dict(t=1.0)

  config["flexi"] = dict(seqhw=dict(
      v=(5, 6, 8, 10, 12, 15, 20, 24, 30, 40),
      p=(1, 1, 1, 1, 1, 34, 1, 1, 1, 1)))

  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["grad_clip_norm"] = 1.0
  config["lr"] = 0.001
  config["wd"] = 0.0001
  config["schedule"] = dict(warmup_steps=5_000, decay_type="cosine")

  config["ckpt_steps"] = arg.ckpt
  config["evals"] = {}

  if arg.runlocal:
    config["total_epochs"] = None
    config["total_steps"] = 3
    config["schedule"] = dict(warmup_steps=1, decay_type="cosine")
    config["input"]["batch_size"] = 8
    config["input"]["data"].update(n=64, unique_images=16)
    config["input"]["shuffle_buffer_size"] = 16
    config["input"]["num_threads"] = 2
    config["input"]["prefetch"] = 1
    config["student"]["variant"] = "mu"
    config["prof"]["variant"] = "mu/8"
    config["log_training_steps"] = 1
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
