"""Well-known teacher checkpoints for distillation: port of
big_vision_tpu/configs/proj/distill/common.py.

The table is kept by name: the BiT-M R152x2 teachers of "Knowledge
distillation: A good teacher is patient and consistent" (arXiv:2106.05237)
and their published files. Nothing is fetched: the port's distill configs
take a local `.npz` as their `teacher_init` arg in place of these files,
and `models/bit_paper.load` refuses a `gs://` name.
"""

inits = {
    "BiT-M R152x2 imagenet2012 ic224":
        "gs://bit_models/distill/R152x2_T_224.npz",
    "BiT-M R152x2 imagenet2012 rc384":
        "gs://bit_models/distill/R152x2_T_384.npz",
    "BiT-M R152x2 flowers rc128":
        "gs://bit_models/distill/R152x2_T_flowers128.npz",
    "BiT-M R152x2 pet rc128":
        "gs://bit_models/distill/R152x2_T_pet128.npz",
    "BiT-M R152x2 food rc128":
        "gs://bit_models/distill/R152x2_T_food128.npz",
    "BiT-M R152x2 sun rc128":
        "gs://bit_models/distill/R152x2_T_sun128.npz",
}
