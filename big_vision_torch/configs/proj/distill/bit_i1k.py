"""Patient and consistent distillation of BiT-M R152x2 into BiT-R50x1 on
ImageNet-1k (arXiv:2106.05237): port of
big_vision_tpu/configs/proj/distill/bit_i1k.py.

  python -m big_vision_torch.trainers.proj.distill.distill --workdir wd \
      --config big_vision_torch/configs/proj/distill/bit_i1k.py:teacher_init=<R152x2.npz>
  python -m big_vision_torch.trainers.proj.distill.distill --device cpu \
      --workdir wd --config \
      big_vision_torch/configs/proj/distill/bit_i1k.py:runlocal,teacher_init=<npz>

Kept as there: the `bit_paper` student at depth 50 and width 1 and the
`bit_paper` teacher "prof_m" at depth 152 and width 2 (f32, the convs
with TF32 off), 1000 classes, 1200 epochs, the input pp
`decode_jpeg_and_inception_crop(224)|flip_lr|value_range|onehot|keep`,
mixup p=1.0 (student and teacher see the same mixed images), the distance
"kl" at t=1, gradient clip 1.0, scale_by_adam with a bf16 first moment,
lr 0.03, wd 3e-4, 5000 warmup steps then cosine, checkpoints every 1000
steps, and the evals: the student's classification on minival, val and v2
(`student_fwd`, every 1000 steps), its few-shot probe (every 10,000), the
teacher's val (`prof_m_fwd`, every 100,000), and the kl, euclidean and
top-1 agreement distances between the two on val (`student_prof_m_fwd`,
every 1000); with `runlocal` the minival and val splits are the first 16
examples.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split is `common.stand_in`'s:
    synthetic JPEGs of 256x320 of the split's size (or `neval`), or the
    image folder `root`/train or `root`/val with the `root` arg;
  * evals.student_fewshot.datasets.*.data_train,
    evals.student_fewshot.datasets.*.data_test: the synthetic JPEG source
    of `configs/common_fewshot.py`;
  * prof_m_init: the published teacher (its name in `common.inits`, kept
    when `teacher_init` is not given, and refused by `bit_paper.load`) is
    not fetched: the `teacher_init` arg names a local `.npz`, in the BiT
    release's TF layout or the JAX one, in its place;
  * input.batch_size: `BATCH`, one card's share of the JAX run's 4096:
    the largest power of two at which the R50x1 student trains beside the
    R152x2 teacher's forward in f32 on the H100's 80 GB (chip_smoke.py
    --bit tries an update at twice it);
  * student.depth, student.width, prof_m.depth, prof_m.width (runlocal):
    R26x0.5 for both, so that a CPU step is short.

Args (`:name=value,...`), besides the JAX config's: `teacher_init` (the
teacher's `.npz`), `root` (an ImageNet folder with train/ and val/),
`neval` (examples in every eval split, and in every few-shot split),
`fewshot` (the few-shot datasets kept, joined by "+", or "none" for no
probe), `stop` (stop after that many steps), `log` (steps between metric
rows).
"""

from big_vision_torch.configs import common
from big_vision_torch.configs import common_fewshot
from big_vision_torch.configs.proj.distill import common as cd

# The per-card batch (see the docstring).
BATCH = 512

CUTS = {
    "input.data": "no TFDS: imagenet2012 train[:98%] is synthetic JPEGs of "
                  "the split's size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "evals.student_fewshot.datasets.*.data_train":
        "configs/common_fewshot.py",
    "evals.student_fewshot.datasets.*.data_test":
        "configs/common_fewshot.py",
    "prof_m_init": "nothing is fetched: `teacher_init`, a local .npz, in "
                   "place of the published teacher's name",
    "input.batch_size": "BATCH: the largest power of two at which the "
                        "student trains beside the teacher on one 80 GB "
                        "card",
}
RUNLOCAL_CUTS = {
    "student.depth": "R26x0.5 for both models, so that a CPU step is short",
    "student.width": "(as student.depth)",
    "prof_m.depth": "(as student.depth)",
    "prof_m.width": "(as student.depth)",
}


def get_config(arg=None):
  arg = common.parse_arg(arg, runlocal=False, teacher_init="", root="",
                         neval=0, fewshot="", stop=0, log=50)
  config = {}
  config["seed"] = 0

  config["input"] = dict(
      data=common.stand_in("imagenet2012", "train[:98%]", root=arg.root),
      batch_size=BATCH if not arg.runlocal else 16,
      shuffle_buffer_size=250_000 if not arg.runlocal else 50,
  )
  config["num_classes"] = 1000
  config["total_epochs"] = 1200
  config["init_shapes"] = [(1, 224, 224, 3)]

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  small = dict(depth=26, width=0.5)
  config["student_name"] = "bit_paper"
  config["student"] = dict(depth=50, width=1) if not arg.runlocal else small

  config["teachers"] = ["prof_m"]
  config["prof_m_name"] = "bit_paper"
  config["prof_m_init"] = (arg.teacher_init or
                           cd.inits["BiT-M R152x2 imagenet2012 ic224"])
  config["prof_m"] = (dict(depth=152, width=2) if not arg.runlocal
                      else dict(small))

  pp_common = ("|value_range(-1, 1)"
               "|onehot(1000, key='{lbl}', key_result='labels')"
               "|keep('image', 'labels')")
  config["input"]["pp"] = (
      "decode_jpeg_and_inception_crop(224)|flip_lr"
      + pp_common.format(lbl="label"))
  ppv = "decode|resize_small(256)|central_crop(224)" + pp_common

  config["mixup"] = dict(p=1.0, fold_in=None)
  config["distance"] = "kl"
  config["distance_kw"] = dict(t=1.0)

  config["grad_clip_norm"] = 1.0
  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["lr"] = 0.03
  config["wd"] = 0.0003
  config["schedule"] = dict(warmup_steps=5000, decay_type="cosine")

  minival = "train[99%:]" if not arg.runlocal else "train[:16]"
  val = "validation" if not arg.runlocal else "validation[:16]"

  def data(split, dataset="imagenet2012"):
    return common.stand_in(dataset, split, root=arg.root, n=arg.neval)

  def get_eval(split, dataset="imagenet2012", lbl="label"):
    return dict(
        type="classification", pred="student_fwd",
        data=data(split, dataset),
        pp_fn=ppv.format(lbl=lbl), loss_name="softmax_xent",
        log_steps=1000)

  config["evals"] = {}
  config["evals"]["student_minival"] = get_eval(minival)
  config["evals"]["student_val"] = get_eval(val)
  config["evals"]["student_v2"] = get_eval("test", dataset="imagenet_v2")
  if arg.fewshot != "none":
    config["evals"]["student_fewshot"] = common_fewshot.get_fewshot_lsr(
        runlocal=arg.runlocal, examples=arg.neval or None,
        only=tuple(arg.fewshot.split("+")) if arg.fewshot else None)
    config["evals"]["student_fewshot"]["pred"] = "student_fwd"
    config["evals"]["student_fewshot"]["log_steps"] = 10_000
  config["evals"]["teacher_val"] = dict(get_eval(val), pred="prof_m_fwd",
                                        log_steps=100_000)
  config["evals"]["distance_val"] = dict(
      type="proj.distill.distance", pred="student_prof_m_fwd",
      data=data(val),
      pp_fn=ppv.format(lbl="label") + "|keep('image')",
      log_steps=1000,
      distances=({"kind": "kl"}, {"kind": "euclidean"},
                 {"kind": "agree", "k": 1}))
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
