"""PaliGemma trainer (prefix-LM fine-tuning of image and text): port of
big_vision_tpu/trainers/proj/paligemma/train.py on one device.

  python -m big_vision_torch.trainers.proj.paligemma.train \
      --config big_vision_torch/configs/proj/paligemma/smoke.py \
      --workdir <dir> [--device cpu]

The model is the config's `model_name` (proj.paligemma.paligemma), built
for the image size of the config's `init_shapes` where it has them, else of
the training pipeline's images, and drawn from the seed with the JAX
models' initializers. A step is the JAX `update_fn`: the text logits of
`model(image, text, mask_ar, train=True)`, whose LLM reads the prefix-LM
mask also as segment ids (the fused attention of `attn_impl="flash"`); the
next-token cross-entropy over `mask_loss` (logits at t predict token t+1),
with `label_smoothing` spread over the other vocab entries, averaged per
example over its supervised tokens and then over the batch; the gradients
of every param and the optimizer of `optim.make`, run over chunks of
CHUNK_NUMEL parameter elements (`optim.Chain.apply_`: the same arithmetic,
with temporaries the size of a chunk, which at PaliGemma-3B's 2.9e9 f32
parameters is what leaves room for the step); the measurements
`training_loss`, `avg_sup_seqlen`, `max_sup_seqlen`, `l2_grads` and
`l2_params` (after the update).

`model_init` is read by `paligemma.load` (an `.npz` with `img` and `llm`
subtrees, or {"img": file, "llm": file}), with `model_load` as its keyword
arguments. The evaluators get the JAX trainer's predict fns: "perplexity"
({"perplexity": the per-example masked NLL}), "logits", "decode",
"decode_with_logp" and "beam_decode" (`models/proj/paligemma/predict_fns`,
with the config's `decode` settings as defaults and an eval's `pred_kw`
per call). The loop, resume (`utils/checkpoints.py`,
`input_pipeline.training_from_step`), the initial evals with `skip_first`,
`stop_after_steps`, chrono and the metric rows are `big_vision_torch/
train.py`'s. A `mesh` other than one "data" axis is refused: the port runs
on one device.
"""

from __future__ import annotations

import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch import train
from big_vision_torch.models.proj.paligemma import paligemma
from big_vision_torch.models.proj.paligemma import predict_fns as pg_predict

PP_MODULES = ("ops_general", "ops_image", "ops_text", "proj.paligemma.ops")
# Parameter elements per chunk of the optimizer's update (1 GiB of f32).
CHUNK_NUMEL = 2**28
DECODE = dict(max_decode_len=64, eos_token=1)


def next_token_nll(text_logits, text, mask_loss, label_smoothing=0.0):
  """(per-example NLL [B], supervised tokens [B]) of the JAX `loss_fn`:
  logits at t predict token t+1, averaged over the tokens of `mask_loss`;
  the smoothed targets are 1 - s at the token and s / (V - 1) elsewhere."""
  logp = torch.log_softmax(text_logits[:, :-1].float(), dim=-1)
  mask_loss = mask_loss[:, 1:].to(logp.dtype)
  token_logp = logp.gather(-1, text[:, 1:].long()[..., None])[..., 0]
  if label_smoothing > 0:
    # sum_v logp_v * smoothed_v without the [B, T, V] targets.
    off = label_smoothing / (logp.shape[-1] - 1)
    token_nll = -(off * logp.sum(-1) + (1.0 - label_smoothing - off)
                  * token_logp)
  else:
    token_nll = -token_logp
  sup_seqlen = mask_loss.sum(-1)
  return (token_nll * mask_loss).sum(-1) / sup_seqlen.clamp_min(1e-6), \
      sup_seqlen


def next_token_loss(text_logits, text, mask_loss, label_smoothing=0.0):
  """(the batch's mean loss, {"avg_sup_seqlen", "max_sup_seqlen"})."""
  per_example, sup_seqlen = next_token_nll(text_logits, text, mask_loss,
                                           label_smoothing)
  return per_example.mean(), {"avg_sup_seqlen": sup_seqlen.mean(),
                              "max_sup_seqlen": sup_seqlen.max()}


def perplexity(model, batch):
  """{"perplexity": [B]} of the JAX trainer's `perplexity_fn`: the masked
  next-token NLL per example, no smoothing."""
  with torch.no_grad():
    text_logits, _ = model(batch["image"], batch["text"], batch["mask_ar"])
    return {"perplexity": next_token_nll(text_logits, batch["text"],
                                         batch["mask_loss"])[0]}


class Trainer(train.Trainer):
  """The PaliGemma update on the loop of `train.py`."""
  MODEL_NAME = ("proj.paligemma.paligemma",)
  MODEL_MODULE = paligemma

  def __init__(self, config, **kw):
    train.import_pp_modules(config, PP_MODULES)
    super().__init__(config, **kw)
    self.pfns = pg_predict.make_predict_fns(
        self.model, **dict(self.config.get("decode") or DECODE))

  def check_config(self, config):
    super().check_config(config)
    for key in ("mixup", "init_head_bias"):
      if config.get(key) and (key != "mixup" or dict(config[key]).get("p")):
        raise ValueError(f"config key {key!r} is not ported by the PaliGemma "
                         "trainer (the JAX one does not read it)")
    mesh = [tuple(a) for a in config.get("mesh") or [("data", -1)]]
    if mesh != [("data", -1)]:
      raise ValueError(f"config key 'mesh'={mesh} is not ported: the port "
                       "trains on one device")

  def build_model(self, res, channels):
    """The config's model for images of the `init_shapes` (else the
    pipeline's) size."""
    if self.config.get("init_shapes"):
      (_, res, _, channels), _ = self.config["init_shapes"]
    cfg = dict(self.config.get("model") or {})
    cfg["img"] = dict(cfg.get("img") or {}, image_size=res,
                      channels=channels)
    return paligemma.Model(**cfg, device=self.device)

  def _rng(self):
    """The step's generator of the image tower's and the LLM's dropout,
    or None."""
    if not (getattr(self.model.img, "dropout", 0)
            or self.model.llm.model.layers[0].dropout):
      return None
    return input_pipeline.step_generator(
        self.seed + 1, optim.get_count(self.opt_state), self.device)

  def loss_and_grads(self, batch):
    """(loss, {JAX name: gradient}, the sequence-length measures)."""
    for p in self.params.values():
      p.grad = None
    text_logits, _ = self.model(batch["image"], batch["text"],
                                batch["mask_ar"], train=True, rng=self._rng())
    loss, extras = next_token_loss(text_logits, batch["text"],
                                   batch["mask_loss"],
                                   self.config.get("label_smoothing", 0.0))
    del text_logits
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in self.params.items()}
    return loss.detach(), grads, {k: v.detach() for k, v in extras.items()}

  def predict_fns(self):
    # Bound late: `check_config` asks for the names before the model exists.
    def decoding(name):
      def fn(train_state, batch, rng=None, **kw):
        del train_state  # the model holds the params
        return self.pfns[name](batch, rng, **kw)
      return fn

    def logits(train_state, batch):
      del train_state
      return self.pfns["logits"](batch)

    return {"perplexity": lambda ts, batch: perplexity(self.model, batch),
            "logits": logits,
            **{n: decoding(n)
               for n in ("decode", "decode_with_logp", "beam_decode")}}

  def update(self, batch):
    """One step; returns its measurements (device scalars)."""
    loss, grads, extras = self.loss_and_grads(batch)
    with torch.no_grad():
      l2_grads = train.l2(grads.values())
    self.tx.apply_(self.params, grads, self.opt_state,
                   chunk_numel=CHUNK_NUMEL)
    del grads
    for p in self.params.values():
      p.grad = None
    with torch.no_grad():
      return {"training_loss": loss, **extras, "l2_grads": l2_grads,
              "l2_params": train.l2(self.params.values())}


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()
