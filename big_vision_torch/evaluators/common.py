"""Evaluator construction and shared eval input plumbing: port of
big_vision_tpu/evaluators/common.py on one process and one device.

Every evaluator is a class `Evaluator(predict_fn, **cfg)` in a module
`big_vision_torch.evaluators.<type>`, whose `run(train_state)` yields
(metric name, value); the trainer builds them from `config["evals"]` with
`from_config` and writes each metric under the eval's prefix. The JAX
package's `process_sum` and multi-process json writing have nothing to do
on one process and are not ported.
"""

from __future__ import annotations

import functools
import importlib
import json

import torch

from big_vision_torch import input_pipeline


def _normalize_spec(name, cfg, config, get_steps):
  """One eval spec -> (meta, the Evaluator's keyword arguments). meta
  holds the evaluator's module, predict fn name and keyword arguments,
  metric prefix and steps between runs."""
  cfg = dict(cfg)
  meta = {
      "module": cfg.pop("type", name),
      "pred_key": cfg.pop("pred", "predict"),
      "pred_kw": cfg.pop("pred_kw", None),
      "prefix": cfg.pop("prefix", f"{name}/"),
  }
  cfg.pop("skip_first", None)
  meta["logsteps"] = get_steps("log", cfg)
  for typ in ("steps", "epochs", "examples", "percent"):
    cfg.pop(f"log_{typ}", None)
  # The batch size: the eval's own, else the config's batch_size_eval, else
  # the training batch size.
  fallbacks = (config.get("batch_size_eval"),
               dict(config.get("input") or {}).get("batch_size"),
               config.get("batch_size"))
  cfg["batch_size"] = cfg.get("batch_size") or next(
      (b for b in fallbacks if b), None)
  return meta, cfg


def evaluator_module(module):
  """`big_vision_torch.evaluators.<module>`; ValueError where the port has
  no such evaluator."""
  name = f"big_vision_torch.evaluators.{module}"
  try:
    mod = importlib.import_module(name)
  except ModuleNotFoundError as e:
    if e.name is None or not name.startswith(e.name):
      raise  # a module that the evaluator itself imports is missing
    mod = None
  if not hasattr(mod, "Evaluator"):
    raise ValueError(f"evaluator {module!r} is not ported")
  return mod


def from_config(config, predict_fns, write_note=lambda s: s,
                get_steps=lambda key, cfg: cfg[f"{key}_steps"],
                device="cuda"):
  """[(name, evaluator, log steps, metric prefix), ...] from
  config["evals"], each evaluator on `device`."""
  evaluators = []
  for name, raw in (config.get("evals") or {}).items():
    write_note(name)
    meta, kw = _normalize_spec(name, raw, config, get_steps)
    mod = evaluator_module(meta["module"])
    if meta["pred_key"] not in predict_fns:
      raise ValueError(f"Unknown predict_fn {meta['pred_key']!r}; "
                       f"have: {list(predict_fns)}")
    predict_fn = predict_fns[meta["pred_key"]]
    if meta["pred_kw"] is not None:
      predict_fn = functools.partial(predict_fn, **meta["pred_kw"])
    evaluators.append((name, mod.Evaluator(predict_fn, device=device, **kw),
                       meta["logsteps"], meta["prefix"]))
  return evaluators


_PIPELINE_CACHE = {}


def eval_input_pipeline(data, pp_fn, batch_size, device, *, cache="pipeline"):
  """(get_data_iter, steps) for an eval dataset, with caching.

  Cache levels, cheap to rich: "none" builds the pipeline for every
  evaluator; "pipeline" shares it between evaluators of one config;
  "raw_data" also keeps the raw (pre-pp) examples in host memory and runs
  the pp at every evaluation; "final_data" keeps the finished device
  batches (small eval sets).
  """
  cache = (cache or "none").lower()
  if cache not in ("none", "pipeline", "raw_data", "final_data"):
    raise ValueError(f"unknown eval cache level {cache!r}")
  key = (json.dumps(data, sort_keys=True, default=str), pp_fn, batch_size,
         str(torch.device(device)), cache)
  if cache != "none" and key in _PIPELINE_CACHE:
    return _PIPELINE_CACHE[key]

  make_iter, steps = input_pipeline.make_for_inference(
      dict(data), pp=pp_fn, batch_size=batch_size, device=device,
      cache_raw=cache == "raw_data")

  if cache == "final_data":
    @functools.lru_cache(maxsize=1)
    def realized():
      return list(make_iter())
    get_iter = lambda: iter(realized())
  else:
    get_iter = make_iter

  result = (get_iter, steps)
  if cache != "none":
    _PIPELINE_CACHE[key] = result
  return result


def split_batch(batch):
  """(tensors, the rest): the predict fn sees only the tensors (the JAX
  package's jax Arrays)."""
  dev = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
  host = {k: v for k, v in batch.items() if k not in dev}
  return dev, host
