"""The standard few-shot linear-probe eval: port of
big_vision_tpu/configs/common_fewshot.py.

`get_fewshot_lsr` returns the JAX function's eval spec with the same keys:
type "fewshot_lsr", pred "represent", log_steps 25,000, the four datasets
(one with `runlocal`), shots (1, 5, 10, 25), l2_reg 2^10, 3 seeds,
`display_first` and `representation_layer` "pre_logits", and the pp
`decode|resize(<resize>)|central_crop(<target>)|value_range(-1,1)|
keep('image', 'label')`.

Cut, with no dataset: each TFDS split is the port's synthetic JPEG source
(256x320 images, 64 unique) with that dataset's class count and the
split's example count (oxford_iiit_pet 3680/3669, oxford_flowers102
1020/6149, cifar100 50000/10000, imagenet2012 train[:10%] 128117 and
validation 50000); `examples`, where given, sets every split's count
instead (at least 25 times the class count for 25 shots of every class),
and `only`, where given, names the datasets kept.

`CUTS` names the keys of the spec that differ from the JAX function's:
datasets.*.data_train, datasets.*.data_test.
"""

from __future__ import annotations

CUTS = {
    "datasets.*.data_train": "no TFDS: the synthetic JPEG source with the "
                             "dataset's class count and the split's size",
    "datasets.*.data_test": "(as data_train)",
}

# name: (source, class count, training examples, test examples).
DATASETS = {
    "pets": ("oxford_iiit_pet", 37, 3680, 3669),
    "flowers": ("oxford_flowers102", 102, 1020, 6149),
    "cifar100": ("cifar100", 100, 50000, 10000),
    "imagenet": ("imagenet2012", 1000, 128117, 50000),
}


def synthetic(num_classes, n):
  """The synthetic JPEG source standing in for a split."""
  return dict(name="synthetic", n=n, num_classes=num_classes, h=256, w=320,
              encoded=True)


def get_fewshot_lsr(target_resolution=224, resize_resolution=256,
                    runlocal=False, examples=None, only=None, **kw):
  kw.setdefault("representation_layer", "pre_logits")
  kw.setdefault("shots", (1, 5, 10, 25))
  kw.setdefault("l2_reg", 2.0 ** 10)
  kw.setdefault("num_seeds", 3)
  kw.setdefault("display_first",
                [("imagenet", 10)] if not runlocal else [("pets", 10)])

  pp = (f"decode|resize({resize_resolution})"
        f"|central_crop({target_resolution})|value_range(-1,1)"
        "|keep('image', 'label')")

  def ds(name):
    _, num_classes, n_train, n_test = DATASETS[name]
    return dict(data_train=synthetic(num_classes, examples or n_train),
                data_test=synthetic(num_classes, examples or n_test),
                pp=pp, num_classes=num_classes)

  names = only or (("pets",) if runlocal else tuple(DATASETS))
  return dict(type="fewshot_lsr", pred="represent", log_steps=25_000,
              datasets={name: ds(name) for name in names}, **kw)
