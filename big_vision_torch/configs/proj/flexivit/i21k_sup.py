"""FlexiViT-B pre-training on synthetic images: the port's FlexiViT path.

  python -m big_vision_torch.trainers.proj.flexi.train \
      --config big_vision_torch/configs/proj/flexivit/i21k_sup.py --workdir wd
  python -m big_vision_torch.trainers.proj.flexi.train --device cpu \
      --config big_vision_torch/configs/proj/flexivit/i21k_sup.py:runlocal \
      --workdir wd

Source: big_vision_tpu/configs/proj/flexivit/i21k_sup.py ("FlexiViT-B i21k
90ep"). Kept as there: the model (FlexiViT-B: width 768, depth 12, 12
heads, MLP 3072; stored 32x32 patch kernel, learned 7x7 posemb, [cls]
readout, f32 matmuls: the JAX config sets no dtype_mm), 21843 classes,
`init_head_bias` -10, `sigmoid_xent`, scale_by_adam with a bf16 first
moment, gradient clip 1.0, lr 1e-3, wd 1e-4, 10,000 warmup steps then
cosine, 90 epochs, mixup p=0.2, RandAugment `randaug(2,10)` on the
card after the crop and flip, and the token grids seqhw (5, 6, 8, 10,
12, 15, 20, 24, 30, 40) with weights 34/43 for 15 and 1/43 for each other,
a checkpoint every 1000 steps, and the evals: classification (`prec@1`,
`loss`) at seqhw 5, 10, 15 and 30 (`test_05` ... `test_30`, pp
`decode|resize_small(274)|central_crop(240)|...`) every 5000 steps, and the
few-shot linear probe of `configs/common_fewshot.py` at seqhw 15 every
25,000 steps.

Cut, for one card and no dataset:
  * data: the port's synthetic source (16,384 raw 256x320 images, 512
    unique, labels i % 21843) with `random_crop(240)` in place of
    ImageNet-21k's `decode_jpeg_and_inception_crop(240)` (the port has the
    JPEG decode now; this config keeps raw images); an epoch is the source's 16,384 examples, so 90 epochs are
    46,080 steps;
  * the evals' data: ImageNet-21k's `full[:25_600]` is the same
    synthetic source as JPEGs (25,600 examples), and each few-shot dataset
    the synthetic JPEG source with its class count
    (`configs/common_fewshot.py`);
  * batch 32 per step, one card's share of the JAX run's 4096 over 128
    chips: at seqhw 40 in f32 a step holds about 1.2 GB of activations
    per image; the evals take the same batch.

`CUTS` names the keys that differ from the JAX config (`RUNLOCAL_CUTS`
those of `runlocal` alone): arg, pp_modules, init_shapes, input.data,
input.pp, input.batch_size, input.shuffle_buffer_size, input.prefetch,
model.attn_impl, evals.*.data, evals.*.pp_fn,
evals.fewshot.datasets.*.data_train, evals.fewshot.datasets.*.data_test;
with `runlocal`: total_epochs, total_steps, schedule.warmup_steps,
log_training_steps, input.num_threads, model.variant.

Args (`:name=value,...`): `runlocal` (the tiny version for CPU tests:
ViT-mu, batch 8, 3 steps, 16 images an eval split, few-shot on the pets
stand-in alone, as the JAX config's `runlocal`, with 74 images a split),
`stop` (stop after that many steps, the schedule unchanged), `log` (steps
between metric rows), `neval` (examples in every eval split), `fewshot`
(the few-shot datasets kept, joined by "+", e.g. "pets"), `attn` (the
attention impl: "auto", the JAX package's gate, which at batch 32 takes the
one-shot kernels K1/K2 at seqhw <= 24 and the plain path at seqhw 30 and 40;
"flash", the fused kernels at every seqhw, the blocked K3-K5 at 30 and 40;
or "xla", the plain path everywhere).
"""

from big_vision_torch.configs import common
from big_vision_torch.configs import common_fewshot

CUTS = {
    "arg": "the JAX config keeps its parsed args in the config; no "
           "trainer reads them",
    "pp_modules": "the port's pp modules are all registered on import",
    "init_shapes": "the trainer takes the input shape from the data",
    "input.data": "synthetic raw images in place of imagenet21k",
    "input.pp": "random_crop(240) of raw images in place of the JPEG "
                "decode and inception crop; onehot of the source's 'label'",
    "input.batch_size": "32, one card's share of 4096",
    "input.shuffle_buffer_size": "1024 raw examples",
    "input.prefetch": "4 batches",
    "model.attn_impl": "the `attn` arg (default 'auto', the JAX default)",
    "evals.*.data": "synthetic JPEGs in place of imagenet21k's full[:25_600]",
    "evals.*.pp_fn": "onehot of the source's 'label'",
    "evals.fewshot.datasets.*.data_train": "configs/common_fewshot.py",
    "evals.fewshot.datasets.*.data_test": "configs/common_fewshot.py",
}
RUNLOCAL_CUTS = {
    "total_epochs": "3 steps (total_steps) on the CPU",
    "total_steps": "(as total_epochs)",
    "schedule.warmup_steps": "1, within the 3 steps",
    "log_training_steps": "a row every step",
    "input.num_threads": "2 host threads",
    "model.variant": "ViT-mu",
}


def get_config(arg=None):
  arg = common.parse_arg(arg, runlocal=False, stop=0, log=50, attn="auto",
                         neval=0, fewshot="")
  config = {}
  config["seed"] = 0
  config["total_epochs"] = 90
  config["num_classes"] = 21843
  config["init_head_bias"] = -10.0
  config["loss"] = "sigmoid_xent"
  config["input"] = dict(
      data=dict(name="synthetic", n=16384, num_classes=21843, h=256, w=320,
                unique_images=512, encoded=False),
      batch_size=32,
      shuffle_buffer_size=1024,
      prefetch=4,
      pp=("random_crop(240)|flip_lr|randaug(2,10)|value_range(-1, 1)"
          "|onehot(21843, key='label', key_result='labels')"
          "|keep('image', 'labels')"),
  )
  config["log_training_steps"] = arg.log

  config["model_name"] = "proj.flexi.vit"
  config["model"] = dict(variant="B", pool_type="tok", posemb="learn",
                         patch_size=(32, 32), posemb_size=(7, 7), seqhw=None,
                         attn_impl=arg.attn)
  # The flexible parameter: the token grid (240px => patch 240 // seqhw).
  config["flexi"] = dict(seqhw=dict(
      v=(5, 6, 8, 10, 12, 15, 20, 24, 30, 40),
      p=(1, 1, 1, 1, 1, 34, 1, 1, 1, 1)))

  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["grad_clip_norm"] = 1.0
  config["lr"] = 0.001
  config["wd"] = 0.0001
  config["schedule"] = dict(warmup_steps=10_000, decay_type="cosine")
  config["mixup"] = dict(p=0.2, fold_in=None)

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
    config["model"]["variant"] = "mu"
    config["log_training_steps"] = 1
  # The eval splits' example counts: the JAX config's, or runlocal's.
  neval = arg.neval or (16 if arg.runlocal else 25_600)
  nfewshot = arg.neval or (74 if arg.runlocal else None)
  pp_eval = ("decode|resize_small(274)|central_crop(240)|value_range(-1, 1)"
             "|onehot(21843, key='label', key_result='labels')"
             "|keep('image', 'labels')")
  eval_data = dict(config["input"]["data"], n=neval, encoded=True)
  config["evals"] = {
      f"test_{s:02d}": dict(type="classification", pred=f"predict_seqhw={s}",
                            data=eval_data, pp_fn=pp_eval,
                            loss_name=config["loss"], log_steps=5000)
      for s in (5, 10, 15, 30)}
  config["evals"]["fewshot"] = common_fewshot.get_fewshot_lsr(
      runlocal=arg.runlocal, examples=nfewshot,
      only=tuple(arg.fewshot.split("+")) if arg.fewshot else None)
  config["evals"]["fewshot"]["pred"] = "predict_seqhw=15"
  config["evals"]["fewshot"]["log_steps"] = 25_000

  if arg.stop:
    config["stop_after_steps"] = arg.stop
  return config
