"""Eval-only entry point: build (and load) a model, run the config's evals:
port of big_vision_tpu/tools/eval_only.py on one device.

  python -m big_vision_torch.tools.eval_only --workdir wd \
      --config big_vision_torch/configs/load_and_eval.py:name=vit_i1k,init=<f.npz>
  python -m big_vision_torch.tools.eval_only --workdir wd --config \
      big_vision_torch/configs/load_and_eval.py:name=proj.image_text.siglip_lit_coco,init=<wd>/ckpt.bv-000000010

The model is `big_vision_torch.models.<model_name>` with the config's
`model` keys (and `num_classes`), drawn from the seed and then loaded from
`model_init` through the model's `load` (with `model_load`). Its shapes
come from `init_shapes` by the JAX tool's dtype rule: a 4-D shape is an
image (f32 dummy in JAX; here the image size and channels), any other a
token array (int32; here the text length). A port config without
`init_shapes` (the port's trainers take the image shape from the data)
gives the shape of its input's images.

The predict fns: "predict" (the model's output, or (it, {})) and
"represent" (`pre_logits`), as the JAX tool; for a two-tower model (and
CLIPPO's one tower) the SigLIP trainer's fns ("predict", which reads
whichever of "image" and "labels" a batch holds, "loss", "img", "txt")
and "contrastive" (the same as "predict"). The JAX tool registers "contrastive" only for models
with an `embed_image` attribute, which its two-tower model lacks, and its
"predict" reads batch["image"], which the retrieval evaluator's text
batches lack; so it cannot evaluate a two-tower model, and the port gives
that model the predict fns its own trainer gives its evaluators.

Each eval's metrics are written under its prefix to the workdir's metrics
file (one row) and returned, with its wall time as `z/secs/eval/<name>`
(as the trainers write it).
"""

from __future__ import annotations

import argparse
import importlib
import time

import torch

from big_vision_torch import input_pipeline
from big_vision_torch import train
from big_vision_torch.evaluators import common as eval_common
from big_vision_torch.trainers.proj.image_text import siglip
from big_vision_torch.utils import losses
from big_vision_torch.utils import writers

TWO_TOWERS = "proj.image_text.two_towers"


def shape_kwargs(init_shapes):
  """The port's shape arguments from `init_shapes` (the JAX tool's rule:
  4-D is an image, else tokens)."""
  kw = {}
  for s in init_shapes:
    if len(s) == 4:
      kw.update(image_size=s[1], channels=s[3])
    else:
      kw["text_len"] = s[1]
  return kw


def build_model(config, device):
  """(the config's model drawn from its seed and loaded from `model_init`,
  its module)."""
  model_name = config["model_name"]
  model_mod = importlib.import_module(f"big_vision_torch.models.{model_name}")
  model_kw = dict(config.get("model", {}))
  if "num_classes" in config:
    model_kw["num_classes"] = config["num_classes"]
  init_shapes = config.get("init_shapes")
  if init_shapes is None:  # a port config that takes it from its data
    shape, _ = input_pipeline.element_spec(config["input"])["image"]
    init_shapes = [(1, *shape)]
  shapes = shape_kwargs(init_shapes)
  if model_name != TWO_TOWERS:
    shapes.pop("text_len", None)
  model = model_mod.Model(**model_kw, **shapes, device=device)
  gen = torch.Generator(device=device).manual_seed(config.get("seed", 0))
  model.initialize(gen)
  if config.get("model_init"):
    writers.write_note(f"Loading {config['model_init']}...")
    train.load_into(model, model_mod, config["model_init"], model_kw,
                    config.get("model_load"))
  return model, model_mod


def predict_fns(config, model):
  """{name: fn(train_state, batch)} (see the module docstring)."""
  if config["model_name"] in siglip.MODELS:  # two towers, or CLIPPO's one
    fns = siglip.predict_fns(
        model, getattr(losses, config.get("loss", "sigmoid_xent")))
    fns["contrastive"] = fns["predict"]
    return fns

  def predict(train_state, batch):
    del train_state
    outs = model(batch["image"])
    return outs if isinstance(outs, tuple) else (outs, {})

  def represent(train_state, batch):
    del train_state
    return (model(batch["image"])[1]["pre_logits"],)

  return {"predict": predict, "represent": represent}


def evaluate(config, workdir=None, *, device="cuda"):
  """Runs every eval of `config` once; returns {metric name: value}."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass --device cpu to evaluate on "
                       "the CPU")
  train.import_pp_modules(config, siglip.PP_MODULES)
  model, _ = build_model(config, device)
  train_state = {"params": train.jax_name_params(model)}
  evaluators = eval_common.from_config(
      config, predict_fns(config, model), write_note=writers.write_note,
      get_steps=lambda key, cfg: cfg.get(f"{key}_steps"), device=device)
  mw = writers.MetricWriter(workdir)
  metrics = {}
  try:
    with torch.no_grad():
      for name, evaluator, _, prefix in evaluators:
        writers.write_note(f"Running {name}...")
        t0 = time.perf_counter()
        for key, value in evaluator.run(train_state):
          metrics[f"{prefix}{key}"] = mw.measure(f"{prefix}{key}", value)
        if device.type == "cuda":
          torch.cuda.synchronize(device)
        metrics[f"z/secs/eval/{name}"] = mw.measure(
            f"z/secs/eval/{name}", time.perf_counter() - t0)
    mw.step_end()
  finally:
    mw.close()
  return metrics


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--config", required=True,
                      help="config file, optionally with ':args'")
  parser.add_argument("--workdir", default=None,
                      help="directory for big_vision_metrics.txt")
  parser.add_argument("--device", default="cuda",
                      help="cuda (default) or cpu")
  args = parser.parse_args(argv)
  return evaluate(train.load_config(args.config), args.workdir,
                  device=args.device)


if __name__ == "__main__":
  main()
