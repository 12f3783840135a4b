"""ViT-B/32 on ImageNet-1k with GSAM and no heavy augmentation
(arXiv:2203.08065): port of
big_vision_tpu/configs/proj/gsam/vit_i1k_gsam_no_aug.py.

  python -m big_vision_torch.trainers.proj.gsam.train --workdir wd \
      --config big_vision_torch/configs/proj/gsam/vit_i1k_gsam_no_aug.py
  python -m big_vision_torch.trainers.proj.gsam.train --device cpu \
      --workdir wd \
      --config big_vision_torch/configs/proj/gsam/vit_i1k_gsam_no_aug.py:runlocal

Kept as there: the ViT (`variant` B/32, [cls] readout, a tanh pre-logits
layer, f32 matmuls, the attention gate "auto": at 224px T = 50 tokens of
D = 64, so K1 and K2 in f32, each twice a layer a step, once for the clean
gradient and once at the perturbed weights), 1000 classes,
`sigmoid_xent`, 300 epochs, the pp
`decode_jpeg_and_inception_crop(224)|flip_lr|value_range|onehot|keep` (no
RandAugment, no mixup), scale_by_adam with a bf16 first moment, gradient
clip 1.0, lr 3e-3, wd 1e-3, 10,000 warmup steps then linear to 3e-5 of the
lr, the GSAM block (rho 0.6 to 0.1 as the lr falls from `lr_max` = lr to
`lr_min` = lr x linear_end, alpha 0.6), checkpoints every 1000 steps, the
evals val (train[99%:]) and test (validation) every 2500 steps and the
few-shot probe every 25,000, and `runlocal` (batch 16, shuffle buffer 50,
the few-shot probe on the pets stand-in alone).

The JAX package's GSAM trainer cannot run this config: it passes
`lr_max` and `lr_min` itself and again from `config.gsam`, which names
them (a TypeError). The port's trainer takes the config's values.

Cut (`CUTS`; `RUNLOCAL_CUTS` with `runlocal` only):
  * input.data, evals.*.data: no TFDS. Each split is `common.stand_in`'s:
    synthetic JPEGs of 256x320 of the split's size, or the image folder
    `root`/train or `root`/val with the `root` arg;
  * evals.fewshot.datasets.*.data_train, evals.fewshot.datasets.*.data_test:
    the synthetic JPEG source of `configs/common_fewshot.py`;
  * input.batch_size: BATCH, one card's share of the JAX run's 4096: the
    largest power of two at which ViT-B/32 in f32 under GSAM fits in the
    H100's 80 GB (chip_smoke.py prints its peak);
  * model.variant (runlocal): mu/32 in place of B/32, so that a CPU step
    is short.

Args (`:name=value,...`), besides the JAX config's: `root` (an ImageNet
folder with train/ and val/), `neval` (examples in every classification
split, and in every few-shot split; 32 and 74 with `runlocal`), `fewshot`
(the few-shot datasets kept, joined by "+", or "none" for no probe),
`stop` (stop after that many steps), `log` (steps between metric rows),
`attn` (the attention impl, when not "auto").
"""

from big_vision_torch.configs import common
from big_vision_torch.configs import common_fewshot

# Measured on one H100 80 GB (chip_smoke.py's recipes phase).
BATCH = 1024

CUTS = {
    "input.data": "no TFDS: imagenet2012 train[:99%] is synthetic JPEGs of "
                  "the split's size, or the image folder root/train",
    "evals.*.data": "no TFDS: each split is synthetic JPEGs of its size "
                    "(or `neval`), or the image folder root/val",
    "evals.fewshot.datasets.*.data_train": "configs/common_fewshot.py",
    "evals.fewshot.datasets.*.data_test": "configs/common_fewshot.py",
    "input.batch_size": "the largest power of two at which ViT-B/32 under "
                        "GSAM fits on one 80 GB card",
}
RUNLOCAL_CUTS = {"model.variant": "mu/32, so that a CPU step is short"}


def get_config(arg=None):
  arg = common.parse_arg(arg, variant="B/32", runlocal=False, root="",
                         neval=0, fewshot="", stop=0, log=50, attn="auto")
  config = {}
  config["seed"] = 0

  config["loss"] = "sigmoid_xent"
  config["num_classes"] = 1000
  config["total_epochs"] = 300

  pp_common = ("|value_range(-1, 1)"
               "|onehot(1000, key='label', key_result='labels')"
               "|keep('image', 'labels')")
  config["input"] = dict(
      data=common.stand_in("imagenet2012", "train[:99%]", root=arg.root),
      batch_size=BATCH if not arg.runlocal else 16,
      shuffle_buffer_size=250_000 if not arg.runlocal else 50,
      # GSAM's paper: no heavy augmentation, the inception crop and a flip.
      pp="decode_jpeg_and_inception_crop(224)|flip_lr" + pp_common,
  )
  pp_eval = "decode|resize_small(256)|central_crop(224)" + pp_common
  config["init_shapes"] = [(1, 224, 224, 3)]

  config["log_training_steps"] = arg.log
  config["ckpt_steps"] = 1000

  config["model_name"] = "vit"
  config["model"] = dict(
      variant=arg.variant if not arg.runlocal else "mu/32", rep_size=True,
      pool_type="tok")
  if arg.attn != "auto":
    config["model"]["attn_impl"] = arg.attn

  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["grad_clip_norm"] = 1.0
  config["lr"] = 0.003
  config["wd"] = 0.001  # The effective wd is wd * lr.
  config["schedule"] = dict(warmup_steps=10_000, decay_type="linear",
                            linear_end=0.00003)

  # rho_max = rho_min and alpha = 0 reduce GSAM to SAM.
  config["gsam"] = dict(rho_max=0.6, rho_min=0.1, alpha=0.6,
                        lr_max=config["lr"],
                        lr_min=config["schedule"]["linear_end"]
                        * config["lr"])

  neval = arg.neval or (32 if arg.runlocal else 0)

  def get_eval(split):
    return dict(type="classification",
                data=common.stand_in("imagenet2012", split, root=arg.root,
                                     n=neval),
                pp_fn=pp_eval, loss_name=config["loss"], log_steps=2500)
  config["evals"] = dict(val=get_eval("train[99%:]"),
                         test=get_eval("validation"))
  if arg.fewshot != "none":
    config["evals"]["fewshot"] = common_fewshot.get_fewshot_lsr(
        runlocal=arg.runlocal,
        examples=arg.neval or (74 if arg.runlocal else None),
        only=tuple(arg.fewshot.split("+")) if arg.fewshot else None)
  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
