"""JetFormer trainer (one likelihood of images and text, through a Jet
adaptor): port of big_vision_tpu/trainers/proj/jetformer/train.py on one
device.

  python -m big_vision_torch.trainers.proj.jetformer.train \
      --config big_vision_torch/configs/proj/jetformer/smoke.py \
      --workdir <dir> [--device cpu]

The models: `patch_pca` (proj.jetformer.patch_pca, parameter-free), the
config's `model_name` (proj.jetformer.jetformer) and, with an
`adaptor_name` (proj.jet.jet), the Jet flow over the patch latents; their
params are one tree, the adaptor's under "params_adaptor/"
(`jetformer.Joint`). A step is the JAX `update_fn`, per batch: the order of
each example (text first with probability `text_prefix_prob`); the
RGB-noise curriculum (`noise_scale` to `noise_min` on a cosine of the
step's progress, `_quantized_noise`; only on image suffixes without
`rgb_noise_on_image_prefix`); the patches with their dequantization noise;
the adaptor's latents and log-determinant; the last `latent_noise_dim`
channels factored out against N(0, 1); teacher-forcing input noise
(`input_noise_std`, text-first examples only); CFG label drops
(`drop_labels_probability`, text-first only); the image NLL in bits per
subpixel with the log-determinant and the [0, 255] -> [-1, 1] change of
variables, the text NLL in nats per token over `text_loss`; the loss over
both orders (`loss_on_prefix`) or over each example's suffix, with
`text_loss_weight`. The measurements: `training_loss`, `l2_grads` (frozen
params as 0), `l2_params`, `l2_params_adaptor`, `noise_scale` and every
`train/` metric of the loss (`nll_text`, `nll_image`, `logdet`, their
prefix and suffix parts). `ema_decay` > 0 keeps EMA params, saved in the
checkpoints.

The step's random draws come from the step's generator of (seed + 1, the
optimizer's count), through `draws`. The evaluators get the predict fns
"validation" (the loss's metrics per example at train=False, draws from a
generator seeded 0) and "sample_images" (`predict_fns.sample_image_latents`
with the config's `sample_images` settings, then `decode_images`). A
`mesh` other than one "data" axis is refused; the config's FSDP
`sharding_strategy` has nothing to shard on one device. The loop, resume,
`model_init` through `jetformer.load`, checkpoints and the metric rows are
`big_vision_torch/train.py`'s.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from big_vision_torch import input_pipeline
from big_vision_torch import optim
from big_vision_torch import train
from big_vision_torch.models.proj.jet import jet
from big_vision_torch.models.proj.jetformer import jetformer
from big_vision_torch.models.proj.jetformer import patch_pca as pca_lib
from big_vision_torch.trainers.proj.jetformer import predict_fns as pf

PP_MODULES = ("ops_general", "ops_image", "ops_text")
LOG2 = math.log(2)


def quantized_noise(images, noise_scale, noise):
  """The RGB-noise curriculum: `noise_scale` * `noise` (a standard normal
  of the images' shape) added to the images as uint8 levels, rounded."""
  u8 = torch.round((images + 1) * 127.5)
  u8 = u8 + noise_scale * noise
  return torch.round(u8) / 127.5 - 1


def cosine_noise_scale(config, count, total_steps):
  """`noise_min` + (`noise_scale` - `noise_min`) * (1 + cos(pi * count /
  total_steps)) / 2 in f32, or None where `noise_scale` is not > 0."""
  top = config.get("noise_scale", 0.0)
  if not top > 0.0:
    return None
  floor = config.get("noise_min", 0.0)
  progress = torch.tensor(count, dtype=torch.float32) / total_steps
  return floor + (top - floor) * 0.5 * (1 + torch.cos(math.pi * progress))


def _masked_mean(x, where, valid=None):
  """mean(x) over `where` (and the batch's `_mask` rows)."""
  if valid is not None:
    where = valid if where is None else where & valid
  if where is None:
    return x.mean()
  w = where.to(x.dtype)
  return (x * w).sum() / w.sum()


class Trainer(train.Trainer):
  """The JetFormer update on the loop of `train.py`."""
  MODEL_NAME = ("proj.jetformer.jetformer",)
  MODEL_MODULE = jetformer

  def __init__(self, config, **kw):
    train.import_pp_modules(config, PP_MODULES)
    config = dict(config)
    pca = dict(config["patch_pca"])
    if pca["model_name"] != "proj.jetformer.patch_pca":
      raise ValueError("JetFormer uses proj.jetformer.patch_pca as the "
                       "embedder")
    self.patch_pca = pca_lib.Model(**dict(pca.get("model", {})))
    self.noise_dim = config.get("latent_noise_dim", 0)
    super().__init__(config, **kw)
    self.ema_decay = self.config.get("ema_decay", 0.0)
    self.params_ema = None
    if self.ema_decay > 0.0:
      self.params_ema = {n: p.detach().clone()
                         for n, p in self.params.items()}

  def check_config(self, config):
    super().check_config(config)
    if config.get("mixup") and dict(config["mixup"]).get("p"):
      raise ValueError("config key 'mixup' is not ported by the JetFormer "
                       "trainer (the JAX one does not read it)")
    mesh = [tuple(a) for a in config.get("mesh") or [("data", -1)]]
    if mesh != [("data", -1)]:
      raise ValueError(f"config key 'mesh'={mesh} is not ported: the port "
                       "trains on one device")
    if config.get("adaptor_name", "proj.jet.jet") not in ("", "proj.jet.jet"):
      raise ValueError(f"adaptor_name={config['adaptor_name']!r}: the port "
                       "has proj.jet.jet")

  def build_model(self, res, channels):
    """JetFormer and its adaptor over the `init_shapes` image's patches."""
    del res, channels
    (_, h, w, _), *_ = self.config["init_shapes"]
    model = jetformer.Model(**self.config.get("model", {}),
                            device=self.device)
    adaptor = None
    if self.config.get("adaptor_name"):
      (ph, pw) = self.patch_pca.patch_size
      adaptor = jet.Model(
          **dict(self.config["adaptor"]["model"]),
          image_shape=(h // ph, w // pw, self.patch_pca.codeword_dim),
          device=self.device)
    return jetformer.Joint(model, adaptor)

  # State: the params, the optimizer's state and the EMA params.

  def state(self):
    out = super().state()
    if self.params_ema is not None:
      out["params_ema"] = self.params_ema
    return out

  def restore_state(self, loaded):
    super().restore_state(loaded)
    if self.params_ema is not None:
      self.params_ema = {n: loaded["params_ema"][n].to(self.device)
                         for n in self.params}

  @contextlib.contextmanager
  def _ema_params(self, use_ema):
    """The EMA params in the model for the duration (use_ema)."""
    if not use_ema:
      yield
      return
    saved = {n: p.detach().clone() for n, p in self.params.items()}
    with torch.no_grad():
      for n, p in self.params.items():
        p.copy_(self.params_ema[n])
    try:
      yield
    finally:
      with torch.no_grad():
        for n, p in self.params.items():
          p.copy_(saved[n])

  # The loss.

  def draws(self, batch, generator, train=True):
    """The random draws of one loss: {"order": text first [B] bool,
    "rgb": N(0, 1) of the images' shape, "dequant": the patches'
    dequantization noise, "in_std" [B, 1, 1] and "in_noise" [B, N, C] of
    the teacher-forcing noise, "drop": the CFG label drops [B] or None}."""
    images = batch["image"]
    bs = images.shape[0]
    dev = images.device
    model = self.model.model
    out = {"order": torch.rand((bs,), generator=generator, device=dev)
                    < self.config.get("text_prefix_prob", 0.5)}
    if self.config.get("noise_scale", 0.0) > 0.0:
      out["rgb"] = torch.randn(images.shape, generator=generator, device=dev)
    if self.patch_pca.add_dequant_noise:
      out["dequant"] = self.patch_pca.dequant_noise(images, generator)
    in_std = self.config.get("input_noise_std", 0.0)
    if train and in_std > 0.0:
      (ph, pw), c = self.patch_pca.patch_size, model.out_dim
      n = (images.shape[1] // ph) * (images.shape[2] // pw)
      out["in_std"] = torch.rand((bs, 1, 1), generator=generator,
                                 device=dev) * in_std
      out["in_noise"] = torch.randn((bs, n, c), generator=generator,
                                    device=dev)
    out["drop"] = model.get_drop_labels(generator, bs) if train else None
    return out

  def adapt(self, images, noise=None):
    """images -> (soft tokens [B, N, C], the adaptor's log-det [B])."""
    tokens, logvar = self.patch_pca.encode(images, noise=noise)
    tokens = self.patch_pca.reparametrize(tokens, logvar)
    if self.model.adaptor is None:
      return tokens, torch.zeros(tokens.shape[0], device=tokens.device)
    z, logdet = self.model.adaptor(pf.unflatten_latents(tokens))
    return pf.flatten_latents(z), logdet

  def jetformer_loss(self, batch, draws, noise_scale=None, train=True,
                     rng=None):
    """(loss, {metric: value}) of the JAX `loss_fn` on the given draws;
    `rng` draws the model's dropout."""
    config, model = self.config, self.model.model
    images, text = batch["image"], batch["text"]
    bs = images.shape[0]
    text_mask = batch.get("text_mask")
    if text_mask is not None:
      text_mask = text_mask.bool()
    text_loss = batch.get("text_loss")
    text_loss = (torch.ones(text.shape, dtype=torch.bool, device=text.device)
                 if text_loss is None else text_loss.bool())
    text_first = draws["order"]

    if noise_scale is not None:
      if not config.get("rgb_noise_on_image_prefix", True):
        noise_scale = torch.where(text_first, noise_scale.to(images.device),
                                  0.0)[:, None, None, None]
      images = quantized_noise(images, noise_scale, draws["rgb"])

    image_tokens, sum_log_det = self.adapt(images, draws.get("dequant"))
    noise_nll = 0.0
    if self.noise_dim > 0:
      image_tokens, factored = image_tokens.split(
          [model.out_dim, self.noise_dim], dim=-1)
      noise_nll = 0.5 * (factored ** 2 + math.log(2 * math.pi)).sum((1, 2))
    if "in_std" in draws:
      std = torch.where(text_first[:, None, None], draws["in_std"], 0.0)
      image_tokens = image_tokens + std * draws["in_noise"]

    drop_prefix = draws.get("drop")
    if drop_prefix is None:
      drop_prefix = torch.zeros((bs,), dtype=torch.bool, device=text.device)
    drop_prefix = drop_prefix & text_first
    if config.get("stop_grad_nvp_prefix", False):
      image_tokens = torch.where(text_first[:, None, None], image_tokens,
                                 image_tokens.detach())

    *_, pmf, pdf, _ = model(text, image_tokens, text_first,
                            text_input_mask=text_mask,
                            drop_prefix=drop_prefix, train=train, rng=rng)
    tl = text_loss.float()
    nll_txt = (-pmf.log_prob(text) * tl).sum(1) / tl.sum(1)
    num_subpixels = float(np.prod(images.shape[1:]))
    nll_img_tok = ((-pdf.log_prob(image_tokens)).sum(1) + noise_nll) / (
        num_subpixels) / LOG2
    logdet = (sum_log_det / num_subpixels - math.log(127.5)) / LOG2
    nll_image = nll_img_tok - logdet

    valid = batch.get("_mask")
    valid = valid.bool() if valid is not None else None
    mean = lambda x, where=None: _masked_mean(x, where, valid)
    metrics = {
        "nll_text_prefix": mean(nll_txt, text_first & ~drop_prefix),
        "nll_text_suffix": mean(nll_txt, ~text_first),
        "nll_image_prefix": mean(nll_image, ~text_first & ~drop_prefix),
        "nll_image_suffix": mean(nll_image, text_first),
    }
    text_w = config.get("text_loss_weight", 1.0)
    if config.get("loss_on_prefix", True):
      metrics["nll_text"] = mean(nll_txt, ~text_first | ~drop_prefix)
      metrics["nll_image"] = mean(nll_image, text_first | ~drop_prefix)
      metrics["logdet"] = mean(logdet)
      loss = metrics["nll_text"] * text_w + metrics["nll_image"]
    else:
      metrics["nll_text"] = mean(nll_txt, ~text_first)
      metrics["nll_image"] = mean(nll_image, text_first)
      metrics["nll_image_tokens"] = mean(nll_img_tok, text_first)
      metrics["logdet"] = mean(logdet, text_first)
      loss = mean(torch.where(~text_first, nll_txt * text_w, nll_image))
    metrics["loss"] = loss
    return loss, metrics

  def step_generator(self):
    return input_pipeline.step_generator(
        self.seed + 1, optim.get_count(self.opt_state), self.device)

  def loss_and_grads(self, batch):
    """(loss, {JAX name: gradient}, metrics, noise_scale) of one batch."""
    gen = self.step_generator()
    count = optim.get_count(self.opt_state)
    noise_scale = cosine_noise_scale(self.config, count, self.total_steps)
    for p in self.params.values():
      p.grad = None
    loss, metrics = self.jetformer_loss(batch, self.draws(batch, gen),
                                        noise_scale, rng=gen)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in self.params.items()}
    return loss.detach(), grads, metrics, noise_scale

  def update(self, batch):
    """One step; returns its measurements (device scalars)."""
    loss, grads, metrics, noise_scale = self.loss_and_grads(batch)
    frozen = set(self.tx.frozen)
    with torch.no_grad():
      l2_grads = train.l2(g for n, g in grads.items() if n not in frozen)
    _, self.opt_state = self.tx.apply_(self.params, grads, self.opt_state)
    with torch.no_grad():
      if self.params_ema is not None:
        names = list(self.params)
        torch._foreach_lerp_([self.params_ema[n] for n in names],
                             [self.params[n] for n in names],
                             1.0 - self.ema_decay)
      out = {"training_loss": loss, "l2_grads": l2_grads,
             "l2_params": train.l2(self.params.values())}
      if self.model.adaptor is not None:
        out["l2_params_adaptor"] = train.l2(
            p for n, p in self.params.items()
            if n.startswith("params_adaptor/"))
      if noise_scale is not None:
        out["noise_scale"] = noise_scale
      out.update({f"train/{k}": v.detach() for k, v in metrics.items()})
    return out

  def predict_fns(self):
    def validation(train_state, batch, *, use_ema=False):
      del train_state  # the model holds the params
      gen = torch.Generator(device=self.device).manual_seed(0)
      with self._ema_params(use_ema), torch.no_grad():
        _, aux = self.jetformer_loss(
            batch, self.draws(batch, gen, train=False), train=False)
      bs = batch["text"].shape[0]
      return {k: v.expand(bs) for k, v in aux.items()}

    def sample_images(train_state, batch, *, decode_len=None, use_ema=False):
      del train_state
      sic = dict(self.config.get("sample_images") or {})
      text = batch["text"]
      batch = {**batch, "text": text if text.dim() >= 2 else text[:, None]}
      gen = torch.Generator(device=self.device).manual_seed(0)
      with self._ema_params(use_ema), torch.no_grad():
        out = pf.sample_image_latents(
            batch, model=self.model.model,
            decode_len=decode_len or self.config.get("decode_len", 256),
            cfg_weight=sic.get("cfg_inference_weight", 0.0),
            temperature=sic.get("temperature", 1.0),
            temperature_probs=sic.get("temperature_probs", 1.0),
            generator=gen)
        tokens = out["out_tokens"]
        if self.noise_dim > 0:  # fresh factored-out noise channels
          tail = torch.randn(tokens.shape[:-1] + (self.noise_dim,),
                             generator=gen, device=tokens.device)
          tokens = torch.cat([tokens, tail], dim=-1)
        images = pf.decode_images(tokens, adaptor=self.model.adaptor,
                                  patch_pca=self.patch_pca)
      return {"images": images, "logp": out["out_logp"]}

    return {"validation": validation, "sample_images": sample_images}


def main(argv=None):
  return train.main(argv, trainer_cls=Trainer, description=__doc__)


if __name__ == "__main__":
  main()
