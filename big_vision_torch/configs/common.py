"""Config helpers: port of `parse_arg` in big_vision_tpu/configs/common.py.

The port's configs are plain-Python `get_config(arg)` factories that return
plain dicts (ml_collections is not a dependency of the port); `parse_arg`
reads the same ":res=128,runlocal" argument language as the JAX package.
`stand_in` gives the source that takes the place of a TFDS split.
"""

from __future__ import annotations

import os
import types


def _bare_to_kv(token, schema):
  """A single bare value: a schema name (or an empty schema) is that bool
  flag set to True; anything else binds to the first schema entry."""
  if token in schema or not schema:
    return f"{token}=True"
  return f"{next(iter(schema))}={token}"


def _split_kv(arg):
  """','-separated name=value items; an item without '=' is True."""
  kv = {}
  for piece in arg.split(","):
    if not piece:
      continue
    name, sep, val = piece.partition("=")
    kv[name] = val if sep else "True"
  return kv


def _strict_bool(x):
  if x.lower() not in {"true", "false", ""}:
    raise ValueError(f"Bad bool string {x!r}")
  return x.lower() == "true"


def _type_with_default(v):
  if isinstance(v, (tuple, list)):
    if len(v) != 2 or not isinstance(v[1], type):
      raise ValueError("Pass (default, type); collection-typed args are "
                       "unsupported (',' is the delimiter)")
    return v
  if isinstance(v, bool):
    return v, _strict_bool
  return v, type(v)


def autotype(x):
  """"true"/"false" -> bool, then int, then float, else the string."""
  low = x.lower()
  if low in ("true", "false"):
    return low == "true"
  for cast in (int, float):
    try:
      return cast(x)
    except ValueError:
      pass
  return x


def parse_arg(arg, lazy=False, **spec):
  """Parses 'res=128,runlocal'-style config args with typed defaults into
  a namespace (attribute access, as the JAX package's ConfigDict)."""
  schema = {k: _type_with_default(v) for k, v in spec.items()}
  text = arg or ""
  if text and "," not in text and "=" not in text:
    text = _bare_to_kv(text, schema)
  kv = _split_kv(text)
  out = {name: cast(kv.pop(name)) if name in kv else default
         for name, (default, cast) in schema.items()}
  if kv and not lazy:
    raise ValueError(f"Unhandled config args remain: {kv}")
  out.update({extra: autotype(v) for extra, v in kv.items()})
  return types.SimpleNamespace(**out)


# The TFDS splits that the ported configs name: (examples, classes). The
# port has no TFDS; `stand_in` gives each a source of the same size.
SPLITS = {
    ("imagenet2012", "train[:99%]"): (1_268_355, 1000),
    ("imagenet2012", "train[99%:]"): (12_812, 1000),
    ("imagenet2012", "train[:2%]"): (25_623, 1000),
    ("imagenet2012", "validation"): (50_000, 1000),
    ("imagenet_v2", "test"): (10_000, 1000),
    ("imagenet2012_real", "validation"): (50_000, 1000),
    **{(c, s): (n, k) for c, k in (("cifar10", 10), ("cifar100", 100))
       for s, n in (("train[:98%]", 49_000), ("train[98%:]", 1_000),
                    ("test", 10_000))},
    ("oxford_iiit_pet", "train[:90%]"): (3_312, 37),
    ("oxford_iiit_pet", "train[90%:]"): (368, 37),
    ("oxford_iiit_pet", "test"): (3_669, 37),
    ("oxford_flowers102", "train[:90%]"): (918, 102),
    ("oxford_flowers102", "train[90%:]"): (102, 102),
    ("oxford_flowers102", "test"): (6_149, 102),
    # imagenet21k's `full` split taken as 13,151,276 examples (TFDS's
    # catalog figure; no copy of TFDS here can confirm it).
    ("imagenet21k", "full[51200:]"): (13_151_276 - 51_200, 21_843),
    **{("imagenet21k", s): (25_600, 21_843)
       for s in ("full[:25_600]", "full[25_600:51_200]",
                 "full[51_200:76_800]")},
    # COCO captions, Karpathy's splits; the "classes" are COCO's 80
    # categories, from which the stand-in draws five captions an image.
    ("coco_captions", "train"): (82_783, 80),
    ("coco_captions", "val"): (5_000, 80),
    # The splits of the PaliGemma transfer config: TFDS's catalog sizes
    # (train 82,783, restval 30,504, val 5,000) with TFDS's rounding of
    # percent slices (2% of train: 1,656); no copy of TFDS here can confirm
    # them.
    ("coco_captions", "train[:98%]+restval"): (81_127 + 30_504, 80),
    ("coco_captions", "train+restval"): (82_783 + 30_504, 80),
    ("coco_captions", "train[:2%]"): (1_656, 80),
    ("coco_captions", "train[-2%:]"): (1_656, 80),
    # Jet's downsampled ImageNet (TFDS's catalog sizes) and JetFormer's
    # slices of imagenet2012's train split (1,281,167 examples).
    ("downsampled_imagenet/64x64", "train"): (1_281_167, 1000),
    ("downsampled_imagenet/64x64", "validation"): (50_000, 1000),
    ("imagenet2012", "train[4096:]"): (1_281_167 - 4096, 1000),
    ("imagenet2012", "train[:4096]"): (4096, 1000),
    # The distillation configs' splits (TFDS's catalog sizes, percent
    # slices rounded to the closest example as TFDS does; no copy of TFDS
    # here can confirm them). food101 has no "test" split in TFDS (train
    # 75,750 and validation 25,250): bigsweep_food_sun.py's eval names one,
    # and its stand-in takes the validation split's size.
    ("imagenet2012", "train[:98%]"): (1_255_544, 1000),
    ("imagenet2012", "train[:16]"): (16, 1000),
    ("imagenet2012", "validation[:16]"): (16, 1000),
    ("oxford_flowers102", "train"): (1_020, 102),
    ("food101", "train"): (75_750, 101),
    ("food101", "test"): (25_250, 101),
    ("sun397", "train"): (76_128, 397),
    ("sun397", "test"): (21_750, 397),
}


def stand_in(name, split, *, root="", n=0):
  """The port's source for the TFDS split `name`/`split`: with `root`, the
  image folder root/train (a "train" split, whole) or root/val (any
  other); else synthetic JPEGs (32x32 for CIFAR, 64x64 for downsampled
  ImageNet, 256x320 otherwise, 512 unique) with the split's class count
  and its example count, or `n`; COCO captions' with "image/id" and five
  captions an image (`datasets/synthetic.captions`)."""
  if root:
    sub = "train" if split.startswith("train") else "val"
    return dict(name="imagefolder", root=os.path.join(root, sub))
  examples, classes = SPLITS[name, split]
  h, w = ((32, 32) if name.startswith("cifar") else
          (64, 64) if name.startswith("downsampled_imagenet") else (256, 320))
  out = dict(name="synthetic", n=n or examples, num_classes=classes, h=h,
             w=w, unique_images=512)
  if name == "coco_captions":
    out["captions"] = 5
  return out
