"""Patient distillation of BiT-M R152x2 into BiT-R50x1 on Flowers102 or
Pets at 128 px (arXiv:2106.05237's fast/medium/long sweep): port of
big_vision_tpu/configs/proj/distill/bigsweep_flowers_pet.py.

  python -m big_vision_torch.trainers.proj.distill.distill --workdir wd \
      --config big_vision_torch/configs/proj/distill/bigsweep_flowers_pet.py:data=pet,teacher_init=<R152x2.npz>

Kept as there: the table `H` (epochs, lr, wd and temperature per dataset
and `variant`), the datasets (flowers: oxford_flowers102 `train`, 102
classes; pet: oxford_iiit_pet `train[:90%]`, 37 classes), the `bit_paper`
student at depth 50 and width 1 and teacher "prof_m" at depth 152 and
width 2 (f32), the train pp `decode|<crop>|flip_lr|value_range|onehot|
keep` (`crop` `inception_crop(128)`), the eval pp `decode|
resize_small(146)|central_crop(128)|...`, batch 512, mixup p=1.0, the
distance "kl" at the table's t, gradient clip 1.0, scale_by_adam with a
bf16 first moment, 500 warmup steps then cosine, checkpoints every 1000
steps, the student's classification on the `test` split every 1000
steps, and the args `runlocal`, `data`, `variant` and `crop`.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only): as
`bigsweep_food_sun.py`, which shares `build`:
  * input.data, evals.*.data: no TFDS. Each split is `common.stand_in`'s:
    synthetic JPEGs of 256x320 of the split's size (or `neval`), or the
    image folder `root`/train or `root`/val with the `root` arg;
  * prof_m_init: the published teacher (its name in `common.inits`, kept
    when `teacher_init` is not given, and refused by `bit_paper.load`) is
    not fetched: the `teacher_init` arg names a local `.npz` in its place;
  * student.depth, student.width, prof_m.depth, prof_m.width (runlocal):
    R26x0.5 for both, so that a CPU step is short.

Args (`:name=value,...`), besides the JAX config's: `teacher_init`,
`root`, `neval`, `stop`, `log` (as in `bit_i1k.py`).
"""

from big_vision_torch.configs import common
from big_vision_torch.configs.proj.distill import common as cd

H = {'flowers': {'fast': dict(epochs=1_000, lr=3e-3, wd=1e-4, t=10.), 'medium': dict(epochs=10_000, lr=1e-3, wd=1e-4, t=10.), 'long': dict(epochs=100_000, lr=3e-4, wd=1e-5, t=10.)}, 'pet': {'fast': dict(epochs=300, lr=1e-3, wd=1e-5, t=5.), 'medium': dict(epochs=1_000, lr=3e-4, wd=1e-5, t=2.), 'long': dict(epochs=30_000, lr=3e-4, wd=1e-5, t=1.)}}  # pylint: disable=line-too-long

# name: (classes, training split, teacher), and the TFDS dataset names.
DATASETS = {'flowers': (102, 'train', 'BiT-M R152x2 flowers rc128'), 'pet': (37, 'train[:90%]', 'BiT-M R152x2 pet rc128')}  # pylint: disable=line-too-long
TFDS_NAMES = dict(flowers="oxford_flowers102", pet="oxford_iiit_pet")

CUTS = {
    "input.data": "no TFDS: the training split is synthetic JPEGs of its "
                  "size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "prof_m_init": "nothing is fetched: `teacher_init`, a local .npz, in "
                   "place of the published teacher's name",
}
RUNLOCAL_CUTS = {
    "student.depth": "R26x0.5 for both models, so that a CPU step is short",
    "student.width": "(as student.depth)",
    "prof_m.depth": "(as student.depth)",
    "prof_m.width": "(as student.depth)",
}


def build(arg, h, datasets, tfds_names):
  """The config of one bigsweep file, from its tables."""
  config = {}
  config["seed"] = 0

  nclass, split, teacher = datasets[arg.data]
  name = arg.data if "_" in arg.data else tfds_names[arg.data]
  config["input"] = dict(
      data=common.stand_in(name, split, root=arg.root),
      batch_size=512 if not arg.runlocal else 16,
      shuffle_buffer_size=50_000 if not arg.runlocal else 50,
  )
  config["num_classes"] = nclass
  config["total_epochs"] = h[arg.data][arg.variant]["epochs"]
  config["init_shapes"] = [(1, 128, 128, 3)]

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  small = dict(depth=26, width=0.5)
  config["student_name"] = "bit_paper"
  config["student"] = dict(depth=50, width=1) if not arg.runlocal else small
  config["teachers"] = ["prof_m"]
  config["prof_m_name"] = "bit_paper"
  config["prof_m_init"] = arg.teacher_init or cd.inits[teacher]
  config["prof_m"] = (dict(depth=152, width=2) if not arg.runlocal
                      else dict(small))

  pp_common = ("|value_range(-1, 1)"
               "|onehot({}, key='label', key_result='labels')"
               "|keep('image', 'labels')").format(nclass)
  config["input"]["pp"] = f"decode|{arg.crop}|flip_lr" + pp_common
  ppv = "decode|resize_small(146)|central_crop(128)" + pp_common

  config["mixup"] = dict(p=1.0, fold_in=None)
  config["distance"] = "kl"
  config["distance_kw"] = dict(t=h[arg.data][arg.variant]["t"])

  config["grad_clip_norm"] = 1.0
  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["lr"] = h[arg.data][arg.variant]["lr"]
  config["wd"] = h[arg.data][arg.variant]["wd"]
  config["schedule"] = dict(warmup_steps=500, decay_type="cosine")

  config["evals"] = dict(
      student_val=dict(
          type="classification", pred="student_fwd",
          data=common.stand_in(name, "test", root=arg.root, n=arg.neval),
          pp_fn=ppv, loss_name="softmax_xent", log_steps=1000))
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config


def parse(arg, data):
  return common.parse_arg(arg, runlocal=False, data=data, variant="medium",
                          crop="inception_crop(128)", teacher_init="",
                          root="", neval=0, stop=0, log=50)


def get_config(arg=None):
  return build(parse(arg, "flowers"), H, DATASETS, TFDS_NAMES)
