"""Patient distillation of BiT-M R152x2 into BiT-R50x1 on Food101 or
SUN397 at 128 px (arXiv:2106.05237's fast/medium/long sweep): port of
big_vision_tpu/configs/proj/distill/bigsweep_food_sun.py.

  python -m big_vision_torch.trainers.proj.distill.distill --workdir wd \
      --config big_vision_torch/configs/proj/distill/bigsweep_food_sun.py:data=sun,teacher_init=<R152x2.npz>

Kept as there: the table `H` and the datasets (food: food101 `train`, 101
classes; sun: sun397 `train`, 397 classes); the rest is
`bigsweep_flowers_pet.build`'s, with its cuts. The eval split is `test`
as in the JAX config; TFDS's food101 has none (train and validation), so
that eval names a split the real dataset lacks, and its stand-in takes
the validation split's size (`configs/common.py`).

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only), as
`bigsweep_flowers_pet.py`:
  * input.data, evals.*.data: no TFDS (`common.stand_in`);
  * prof_m_init: the `teacher_init` arg, a local `.npz`, in place of the
    published teacher's name;
  * student.depth, student.width, prof_m.depth, prof_m.width (runlocal):
    R26x0.5 for both.

Args (`:name=value,...`): `runlocal`, `data`, `variant`, `crop`, and
`teacher_init`, `root`, `neval`, `stop`, `log` as in `bit_i1k.py`.
"""

from big_vision_torch.configs.proj.distill import bigsweep_flowers_pet as bs

H = {'food': {'fast': dict(epochs=100, lr=1e-3, wd=1e-5, t=10.), 'medium': dict(epochs=1_000, lr=3e-4, wd=1e-5, t=10.), 'long': dict(epochs=3_000, lr=1e-4, wd=1e-5, t=10.)}, 'sun': {'fast': dict(epochs=100, lr=1e-3, wd=1e-5, t=10.), 'medium': dict(epochs=1_000, lr=3e-4, wd=1e-5, t=10.), 'long': dict(epochs=3_000, lr=1e-4, wd=1e-5, t=10.)}}  # pylint: disable=line-too-long

DATASETS = {'food': (101, 'train', 'BiT-M R152x2 food rc128'), 'sun': (397, 'train', 'BiT-M R152x2 sun rc128')}  # pylint: disable=line-too-long
TFDS_NAMES = dict(food="food101", sun="sun397")

CUTS = bs.CUTS
RUNLOCAL_CUTS = bs.RUNLOCAL_CUTS


def get_config(arg=None):
  return bs.build(bs.parse(arg, "food"), H, DATASETS, TFDS_NAMES)
