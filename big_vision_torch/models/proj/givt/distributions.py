"""The distributions of GIVT and JetFormer's heads: port of
big_vision_tpu/models/proj/givt/distributions.py.

  * PerChannelMixture: an independent 1-D Gaussian mixture per channel.
  * DiagMixture: a mixture of diagonal multivariate Normals (JetFormer's
    GMM head).
  * Categorical: the text head.
  * GaussianCFG: classifier-free guidance p_c^(1+w) / p_u^w per scalar
    channel, sampled by a fixed batch of rejection proposals.
  * MultivariateNormalTri: a Normal with a lower-triangular scale.

Each has `log_prob(x)`, `prob(x)`, `sample(generator)` and `mean()` (the
categorical has none); sampling draws from a `torch.Generator`, so its
draws are not JAX's, but the arithmetic around them is.
`mixture_from_raw`, `per_channel_from_raw` and `mvn_tri_from_raw` build
them from a head's raw outputs, with `square_plus` ((x + sqrt(x^2 + 4)) /
2) for positive scales.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

_LOG2PI = math.log(2 * math.pi)


def _normal_logp(x, loc, scale):
  return -0.5 * (((x - loc) / scale) ** 2 + 2 * torch.log(scale) + _LOG2PI)


def _normal(shape, generator, like):
  return torch.randn(shape, generator=generator, device=like.device,
                     dtype=like.dtype)


def categorical(logits, generator):
  """One draw per row of `logits` [..., K] (the Gumbel-max trick, as
  `jax.random.categorical`)."""
  u = torch.rand(logits.shape, generator=generator, device=logits.device)
  gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
  return (logits + gumbel).argmax(-1)


@dataclasses.dataclass(frozen=True)
class PerChannelMixture:
  """probs/locs/scales: [..., D, M]; events are [..., D] (independent
  channels)."""
  probs: torch.Tensor
  locs: torch.Tensor
  scales: torch.Tensor

  def log_prob(self, x):
    logp = _normal_logp(x[..., None], self.locs, self.scales)
    return torch.logsumexp(torch.log(self.probs + 1e-12) + logp, dim=-1)

  def prob(self, x):
    return torch.exp(self.log_prob(x))

  def sample(self, generator):
    comp = categorical(torch.log(self.probs + 1e-12), generator)
    loc = self.locs.gather(-1, comp[..., None])[..., 0]
    scale = self.scales.gather(-1, comp[..., None])[..., 0]
    return loc + scale * _normal(loc.shape, generator, loc)

  def mean(self):
    return (self.probs * self.locs).sum(-1)


@dataclasses.dataclass(frozen=True)
class DiagMixture:
  """logits: [..., M]; locs/scales: [..., M, D]; events are [..., D]."""
  logits: torch.Tensor
  locs: torch.Tensor
  scales: torch.Tensor

  def log_prob(self, x):
    logp = _normal_logp(x[..., None, :], self.locs, self.scales).sum(-1)
    return torch.logsumexp(F.log_softmax(self.logits, dim=-1) + logp, dim=-1)

  def prob(self, x):
    return torch.exp(self.log_prob(x))

  def pick(self, comp):
    """(loc, scale) [..., D] of component `comp` [...]."""
    idx = comp[..., None, None].expand(*comp.shape, 1, self.locs.shape[-1])
    return (self.locs.gather(-2, idx)[..., 0, :],
            self.scales.gather(-2, idx)[..., 0, :])

  def sample(self, generator):
    loc, scale = self.pick(categorical(self.logits, generator))
    return loc + scale * _normal(loc.shape, generator, loc)

  def mean(self):
    w = torch.softmax(self.logits, dim=-1)[..., None]
    return (w * self.locs).sum(-2)


@dataclasses.dataclass(frozen=True)
class Categorical:
  """logits: [..., V]; events are [...] ints (out of range: -inf)."""
  logits: torch.Tensor

  @property
  def num_categories(self):
    return self.logits.shape[-1]

  def log_prob(self, x):
    logp = F.log_softmax(self.logits, dim=-1)
    x = torch.as_tensor(x, device=self.logits.device)
    valid = (x >= 0) & (x <= self.num_categories - 1)
    gathered = logp.gather(
        -1, x.clamp(0, self.num_categories - 1).long()[..., None])[..., 0]
    return torch.where(valid, gathered, torch.full_like(gathered,
                                                         -math.inf))

  def prob(self, x):
    return torch.exp(self.log_prob(x))

  def sample(self, generator):
    return categorical(self.logits, generator)

  def mean(self):
    raise NotImplementedError("Categorical has no mean.")


def select_component(pdf, generator=None, component=None):
  """(loc, scale, component) of a mixture reduced by one component choice,
  drawn from `pdf` (the conditional density) or replayed from `component`
  (a one-hot), so that guidance compares like with like."""
  if isinstance(pdf, DiagMixture):
    if component is None:
      comp = categorical(pdf.logits, generator)
      component = F.one_hot(comp, pdf.logits.shape[-1]).to(pdf.locs.dtype)
    loc = (pdf.locs * component[..., None]).sum(-2)
    scale = (pdf.scales * component[..., None]).sum(-2)
    return loc, scale, component
  if isinstance(pdf, PerChannelMixture):
    if pdf.locs.shape[-1] == 1:  # one component: nothing to choose
      return pdf.locs[..., 0], pdf.scales[..., 0], None
    if component is None:
      comp = categorical(torch.log(pdf.probs + 1e-12), generator)
      component = F.one_hot(comp, pdf.probs.shape[-1]).to(pdf.locs.dtype)
    loc = (pdf.locs * component).sum(-1)
    scale = (pdf.scales * component).sum(-1)
    return loc, scale, component
  raise ValueError(f"CFG needs a mixture pdf, got {type(pdf)}")


def make_cfg(pdf_c, pdf_u, w, generator):
  """The guided density p_c^(1+w) / p_u^w with shared components."""
  loc_c, scale_c, comp = select_component(pdf_c, generator)
  loc_u, scale_u, _ = select_component(pdf_u, component=comp)
  return GaussianCFG(loc_c, scale_c, loc_u, scale_u, w)


@dataclasses.dataclass(frozen=True)
class GaussianCFG:
  """p_c^(1+w) / p_u^w per scalar channel (loc/scale [..., D] each).

  `sample` is the JAX package's vectorized rejection sampler: a widened
  conditional Normal envelope (twice the larger scale), its factor the
  maximum of p/q over `envelope_grid` points within 10 envelope widths of
  loc_c, `max_samples` proposals of which the first accepted wins, and
  a draw from the conditional Normal where none is.
  """
  loc_c: torch.Tensor
  scale_c: torch.Tensor
  loc_u: torch.Tensor
  scale_u: torch.Tensor
  w: float

  def _unnorm_logp(self, x):
    logp_c = _normal_logp(x, self.loc_c, self.scale_c)
    logp_u = _normal_logp(x, self.loc_u, self.scale_u)
    return (1 + self.w) * logp_c - self.w * logp_u

  def log_prob(self, x):
    return self._unnorm_logp(x)  # unnormalized, as in JAX

  def envelope(self, envelope_grid=257):
    """(the envelope's scale, log of its factor), the sampler's
    deterministic part."""
    scale_env = torch.maximum(self.scale_c, self.scale_u) * 2.0
    offsets = torch.linspace(-10.0, 10.0, envelope_grid,
                             device=self.loc_c.device)
    grid = self.loc_c[None] + offsets.reshape(
        (-1,) + (1,) * self.loc_c.dim()) * scale_env[None]
    log_fac = (self._unnorm_logp(grid) - _normal_logp(
        grid, self.loc_c[None], scale_env[None])).amax(0)
    return scale_env, log_fac

  def sample(self, generator, max_samples=128, envelope_grid=257):
    scale_env, log_fac = self.envelope(envelope_grid)
    shape = (max_samples,) + tuple(self.loc_c.shape)
    xs = self.loc_c[None] + scale_env[None] * _normal(shape, generator,
                                                      self.loc_c)
    log_q = _normal_logp(xs, self.loc_c[None], scale_env[None])
    u = torch.rand(shape, generator=generator, device=xs.device,
                   dtype=xs.dtype) * (1.0 - 1e-20) + 1e-20
    accept = (torch.log(u) + log_fac[None] + log_q) < self._unnorm_logp(xs)
    first = accept.int().argmax(0)
    got_one = accept.any(0)
    picked = xs.gather(0, first[None])[0]
    fallback = self.loc_c + self.scale_c * _normal(self.loc_c.shape,
                                                   generator, self.loc_c)
    return torch.where(got_one, picked, fallback)

  def mean(self):
    return self.loc_c + self.w * (self.loc_c - self.loc_u)


@dataclasses.dataclass(frozen=True)
class MultivariateNormalTri:
  """locs: [..., D]; scale_tril: [..., D, D] (lower-triangular)."""
  locs: torch.Tensor
  scale_tril: torch.Tensor

  def log_prob(self, x):
    tril = torch.tril(self.scale_tril)
    diff = x - self.locs
    z = torch.linalg.solve_triangular(tril, diff[..., None],
                                      upper=False)[..., 0]
    d = x.shape[-1]
    logdet = torch.log(torch.diagonal(tril, dim1=-2, dim2=-1).abs()).sum(-1)
    return -0.5 * ((z ** 2).sum(-1) + d * _LOG2PI) - logdet

  def prob(self, x):
    return torch.exp(self.log_prob(x))

  def sample(self, generator):
    eps = _normal(self.locs.shape, generator, self.locs)
    tril = torch.tril(self.scale_tril)
    return self.locs + torch.einsum("...ij,...j->...i", tril, eps)

  def mean(self):
    return self.locs


def square_plus(x):
  """Smooth positivity map (x + sqrt(x^2 + 4)) / 2, f(0) = 1."""
  return (x + torch.sqrt(torch.square(x) + 4)) / 2


def square_plus_legacy(x):
  """GIVT's original form x + sqrt(x^2 + 4) / 2 (for its checkpoints)."""
  return x + torch.sqrt(torch.square(x) + 4) / 2


def mixture_from_raw(logits, *, num_mixtures, out_dim, scale_tol,
                     sp=square_plus, temp_scales=None, temp_probs=None):
  """DiagMixture from [..., M + 2*M*D] raw channels (mix | locs, scales)."""
  *lead, _ = logits.shape
  mix = logits[..., :num_mixtures]
  if temp_probs is not None:
    mix = mix * temp_probs
  rest = logits[..., num_mixtures:].reshape(*lead, num_mixtures, 2, out_dim)
  scales = torch.clamp(sp(rest[..., 1, :]), min=scale_tol)
  if temp_scales is not None:
    scales = scales * temp_scales
  return DiagMixture(mix, rest[..., 0, :], scales)


def per_channel_from_raw(logits, *, num_mixtures, scale_tol, sp=square_plus,
                         temp_scales=None, temp_probs=None):
  """PerChannelMixture from [..., 3*M*D] raw channels ([probs; locs;
  scales])."""
  logits = logits.reshape(*logits.shape[:-1], 3, -1, num_mixtures)
  probs, locs, scales = (logits[..., i, :, :] for i in range(3))
  if temp_probs is not None:
    probs = probs * temp_probs
  scales = torch.clamp(sp(scales), min=scale_tol)
  if temp_scales is not None:
    scales = scales * temp_scales
  return PerChannelMixture(torch.softmax(probs, dim=-1), locs, scales)


def mvn_tri_from_raw(logits, *, out_dim, scale_tol, sp=square_plus,
                     temp_scales=None):
  """Lower-triangular Normal from [..., D^2 + D] raw channels."""
  *lead, _ = logits.shape
  tri = sp(logits[..., :out_dim ** 2]).reshape(*lead, out_dim, out_dim)
  tri = torch.maximum(tri, torch.eye(out_dim, device=logits.device,
                                     dtype=logits.dtype) * scale_tol)
  if temp_scales is not None:
    tri = tri * temp_scales
  return MultivariateNormalTri(logits[..., out_dim ** 2:], tri)
