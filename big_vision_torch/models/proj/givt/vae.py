"""The base of GIVT's Gaussian VAEs: port of the part of
big_vision_tpu/models/proj/givt/vae.py that JetFormer's `patch_pca`
reaches (it subclasses this `Model` and overrides `encode`, `decode` and
the setup of its encoder and decoder).

Ported: the fields and `reparametrize` (mu + exp(logvar / 2) * N(0, 1)
from a generator, mu without one). The base class's CNN encoder and
decoder (`models/proj/givt/cnn.py`), its code dropout and
`kl_divergence` are not ported: `patch_pca` reaches none of them, and
calling the encoder or the decoder is refused by name.
"""

from __future__ import annotations

import torch
from torch import nn


class Model(nn.Module):
  """(mu, logvar) token codes [B, L, codeword_dim] and their images."""

  def __init__(self, codeword_dim=16, code_len=256, filters=64,
               num_res_blocks=2, channel_multipliers=(1, 2, 4),
               out_channels=3, code_dropout="none"):
    super().__init__()
    if code_dropout not in ("none", "seq", "random"):
      raise ValueError(f"Unknown code_dropout: {code_dropout!r}")
    self.codeword_dim = codeword_dim
    self.code_len = code_len
    self.filters, self.num_res_blocks = filters, num_res_blocks
    self.channel_multipliers = tuple(channel_multipliers)
    self.out_channels = out_channels
    self.code_dropout = code_dropout

  def encode(self, image, train=False):
    raise NotImplementedError(
        "the GIVT VAE's CNN encoder (models/proj/givt/cnn.py) is not ported")

  def decode(self, z, train=False):
    raise NotImplementedError(
        "the GIVT VAE's CNN decoder (models/proj/givt/cnn.py) is not ported")

  def reparametrize(self, mu, logvar, generator=None):
    if generator is None:
      return mu
    std = torch.exp(0.5 * logvar)
    return mu + std * torch.randn(mu.shape, generator=generator,
                                  device=mu.device, dtype=mu.dtype)
