"""Transfer (fine-tune) pre-trained models to small datasets: port of
big_vision_tpu/configs/transfer.py.

  python -m big_vision_torch.train --workdir wd --config \
      big_vision_torch/configs/transfer.py:model=vit-s16,init=<ckpt.npz>
  python -m big_vision_torch.train --device cpu --workdir wd --config \
      big_vision_torch/configs/transfer.py:runlocal,model=vit-s16,init=<npz>

Kept as there: the grid of models (vit-i21k-augreg-b/32, vit-i21k-augreg-
l/16, vit-s16, bit-m-r50x1) x datasets (cifar10, cifar100, imagenet2012,
oxford_iiit_pet, oxford_flowers102) x crops (inception_crop, resmall_crop,
resize_crop) at `h_res` 448 and `l_res` 384, each dataset's steps and
warmup, the head not loaded (`model_load`), `softmax_xent`,
`big_vision.momentum_hp` (SGD with a bf16 momentum), gradient clip 1.0,
lr 0.01, no weight decay, cosine decay, the evals val and test every 100
steps, and the args `model`, `dataset`, `crop`, `h_res`, `l_res`, `fsdp`
and `runlocal`.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split is `common.stand_in`'s:
    synthetic JPEGs (32x32 for CIFAR, 256x320 otherwise) of the split's
    size, or the image folder `root`/train or `root`/val with `root`;
  * model_init: the published checkpoints (the JAX names, kept when
    `init` is not given, and refused by the models' `load`) are not
    fetched: the `init` arg names a local `.npz` in their place, in the
    JAX layout (`models/vit.py` `load`) or, for bit-m-r50x1, in the BiT
    release's TF layout or the JAX one (`models/bit_paper.py` `load`);
  * input.batch_size: one card's share of the JAX run's 512 where that
    does not fit in the H100's 80 GB in f32, the largest power of two
    that does: 256 for vit-s16 (chip_smoke.py prints the peak, over half
    of 80 GB); 32 for vit-i21k-augreg-l/16, and 512 kept for
    vit-i21k-augreg-b/32, both estimated from vit-s16's peak per image
    scaled by depth x tokens x width, not measured; for bit-m-r50x1
    `BATCH`'s, measured (chip_smoke.py --bit tries an update at twice it);
  * fsdp is refused: the port runs one card;
  * model.variant (runlocal): mu at the model's patch size, so that a CPU
    step is short; model.depth, model.width (runlocal): R26x0.5 for
    bit-m-r50x1.

Args (`:name=value,...`), besides the JAX config's: `init` (the model's
`.npz`), `root` (a folder with train/ and val/), `neval` (examples in
every eval split; 16 with `runlocal`), `stop` (stop after that many
steps), `log` (steps between metric rows), `attn` (the attention impl,
when not "auto").
"""

from big_vision_torch.configs import common

CUTS = {
    "input.data": "no TFDS: the training split is synthetic JPEGs of its "
                  "size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "model_init": "nothing is fetched: `init`, a local .npz, in place of "
                  "the published checkpoint's name",
    "input.batch_size": "one card's share where the JAX batch of 512 does "
                        "not fit in 80 GB in f32",
}
RUNLOCAL_CUTS = {"model.variant": "mu at the model's patch size, so that "
                                  "a CPU step is short",
                 "model.depth": "R26x0.5 (bit-m-r50x1), so that a CPU step "
                                "is short",
                 "model.width": "(as model.depth)"}

# The per-card batch of a model at 384px in f32 where the JAX run's 512
# does not fit (see the docstring).
BATCH = {"vit-i21k-augreg-l/16": 32, "vit-s16": 256, "bit-m-r50x1": 128}


def _set_model(config, model, init, runlocal):
  config["model_load"] = dict(dont_load=["head/kernel", "head/bias"])
  if model == "vit-i21k-augreg-b/32":
    config["model_name"] = "vit"
    config["model_init"] = "howto-i21k-B/32"
    config["model"] = dict(variant="B/32", pool_type="tok")
  elif model == "vit-i21k-augreg-l/16":
    config["model_name"] = "vit"
    config["model_init"] = "howto-i21k-L/16"
    config["model"] = dict(variant="L/16", pool_type="tok")
  elif model == "vit-s16":
    config["model_name"] = "vit"
    config["model_init"] = "i1k-s16-300ep"
    config["model"] = dict(variant="S/16", pool_type="gap",
                           posemb="sincos2d", rep_size=True)
  elif model == "bit-m-r50x1":
    config["model_name"] = "bit_paper"
    config["model_init"] = "M"
    config["model"] = dict(depth=50, width=1)
  else:
    raise ValueError(f"Unknown model {model!r}")
  if init:
    config["model_init"] = init
  if runlocal and config["model_name"] == "bit_paper":
    config["model"].update(depth=26, width=0.5)
  elif runlocal:
    config["model"]["variant"] = "mu/" + config["model"]["variant"].split(
        "/")[1]


def _set_task(config, arg, dataset, train, val, test, n_cls, steps=20_000,
              warmup=500, lbl="label", crop="resmall_crop", flip=True,
              h_res=448, l_res=384):
  config["total_steps"] = steps
  config["schedule"] = dict(warmup_steps=warmup, decay_type="cosine")
  config["init_shapes"] = [(1, l_res, l_res, 3)]
  config["input"]["data"] = common.stand_in(dataset, train, root=arg.root)
  pp_common = ("|value_range(-1, 1)|"
               f"onehot({n_cls}, key='{lbl}', key_result='labels')|"
               "keep('image', 'labels')")
  if crop == "inception_crop":
    pp_train = f"decode|inception_crop({l_res})"
  elif crop == "resmall_crop":
    pp_train = f"decode|resize_small({h_res})|random_crop({l_res})"
  elif crop == "resize_crop":
    pp_train = f"decode|resize({h_res})|random_crop({l_res})"
  else:
    raise ValueError(f"Unknown crop {crop!r}")
  if flip:
    pp_train += "|flip_lr"
  config["input"]["pp"] = pp_train + pp_common
  pp = f"decode|resize_small({h_res})|central_crop({l_res})" + pp_common
  config["num_classes"] = n_cls
  neval = arg.neval or (16 if arg.runlocal else 0)

  def get_eval(split):
    return dict(type="classification",
                data=common.stand_in(dataset, split, root=arg.root,
                                     n=neval),
                loss_name="softmax_xent", log_steps=100, pp_fn=pp)
  config["evals"] = dict(val=get_eval(val), test=get_eval(test))


def _set_dataset(config, arg):
  kw = dict(crop=arg.crop, h_res=arg.h_res, l_res=arg.l_res)
  dataset = arg.dataset
  if dataset == "cifar10":
    _set_task(config, arg, "cifar10", "train[:98%]", "train[98%:]", "test",
              10, steps=10_000, warmup=500, **kw)
  elif dataset == "cifar100":
    _set_task(config, arg, "cifar100", "train[:98%]", "train[98%:]", "test",
              100, steps=10_000, warmup=500, **kw)
  elif dataset == "imagenet2012":
    _set_task(config, arg, "imagenet2012", "train[:99%]", "train[99%:]",
              "validation", 1000, steps=20_000, warmup=500, **kw)
  elif dataset == "oxford_iiit_pet":
    _set_task(config, arg, "oxford_iiit_pet", "train[:90%]", "train[90%:]",
              "test", 37, steps=500, warmup=100, **kw)
  elif dataset == "oxford_flowers102":
    _set_task(config, arg, "oxford_flowers102", "train[:90%]",
              "train[90%:]", "test", 102, steps=500, warmup=100, **kw)
  else:
    raise ValueError(f"Unknown dataset {dataset!r}")


def get_config(arg=None):
  arg = common.parse_arg(arg, model="vit-i21k-augreg-b/32",
                         dataset="cifar10", crop="resmall_crop", h_res=448,
                         l_res=384, fsdp=False, runlocal=False, init="",
                         root="", neval=0, stop=0, log=10, attn="auto")
  if arg.fsdp:
    raise ValueError("fsdp is not ported: the port runs one card")
  config = {}
  config["seed"] = 0
  config["input"] = dict(
      batch_size=BATCH.get(arg.model, 512) if not arg.runlocal else 16,
      shuffle_buffer_size=50_000 if not arg.runlocal else 64)
  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["loss"] = "softmax_xent"
  config["optax_name"] = "big_vision.momentum_hp"
  config["grad_clip_norm"] = 1.0
  config["lr"] = 0.01
  config["wd"] = None

  _set_dataset(config, arg)
  _set_model(config, arg.model, arg.init, arg.runlocal)
  if arg.attn != "auto" and config["model_name"] == "vit":
    config["model"]["attn_impl"] = arg.attn
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
