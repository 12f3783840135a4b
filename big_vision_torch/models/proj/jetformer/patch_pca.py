"""JetFormer's patch "tokenizer": port of
big_vision_tpu/models/proj/jetformer/patch_pca.py with `skip_pca=True`.

`encode` cuts an image [B, H, W, 3] into non-overlapping p x q patches,
[B, h*w, p*q*3] (with `add_dequant_noise`, first uniform noise of one
[-1, 1] pixel bin, 1/127.5, from a generator); with `skip_pca` the patch
vectors are the latents and the log-variance is zeros. `decode` puts the
patches back and clips to [-1, 1]. Parameter-free, as in JAX (its `load`
returns {}).

The PCA projection itself (`skip_pca=False`) reads its components from a
`pca_init_file` that is not in the repository, and is refused by name.
"""

from __future__ import annotations

import torch

from big_vision_torch.models.proj.givt import vae


class Model(vae.Model):
  """Patch flattening with the VAE's interface."""

  def __init__(self, pca_init_file="", code_len=256, noise_std=0.01,
               add_dequant_noise=False, input_size=(256, 256),
               patch_size=(16, 16), whiten=True, depth_to_seq=1,
               skip_pca=False, codeword_dim=None, **vae_kw):
    super().__init__(codeword_dim=codeword_dim, code_len=code_len, **vae_kw)
    if codeword_dim is None:
      raise ValueError("patch_pca needs codeword_dim")
    if not skip_pca:
      raise NotImplementedError(
          f"patch_pca with skip_pca=False (the PCA of {pca_init_file!r}) is "
          "not ported: its components file is not in the repository")
    if depth_to_seq != 1:
      raise ValueError("skip_pca needs depth_to_seq=1")
    self.noise_std = noise_std
    self.add_dequant_noise = add_dequant_noise
    self.input_size = tuple(input_size)
    self.patch_size = tuple(patch_size)
    self.whiten = whiten

  @property
  def grid(self):
    (ih, iw), (p, q) = self.input_size, self.patch_size
    return ih // p, iw // q

  def flatten_images(self, x):
    """[B, H, W, C] -> [B, h*w, p*q*C]."""
    b = x.shape[0]
    (h, w), (p, q) = self.grid, self.patch_size
    x = x.reshape(b, h, p, w, q, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, -1)

  def unflatten_patches(self, x):
    """The inverse of `flatten_images` (3 channels)."""
    b = x.shape[0]
    (h, w), (p, q) = self.grid, self.patch_size
    x = x.reshape(b, h, w, p, q, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * q, 3)

  def dequant_noise(self, x, generator):
    """Uniform noise of one [-1, 1] pixel bin (1/127.5), x's shape."""
    return torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) / 127.5

  def encode(self, x, train=False, generator=None, noise=None):
    """(latents, log-variance), each [B, h*w, p*q*3]; where
    `add_dequant_noise`, `noise` (else `dequant_noise` from `generator`) is
    added to the image first."""
    del train
    if self.add_dequant_noise:
      if noise is None:
        if generator is None:
          raise ValueError("add_dequant_noise draws from a generator")
        noise = self.dequant_noise(x, generator)
      x = x + noise
    x = self.flatten_images(x)
    return x, torch.zeros_like(x)

  def reparametrize(self, mu, logvar, generator=None):
    if self.noise_std <= 0.0:
      return mu
    return super().reparametrize(mu, logvar, generator)

  def decode(self, x, train=False):
    del train
    return self.unflatten_patches(x).clamp(-1.0, 1.0)


def load(*args):
  """The model has no params."""
  del args
  return {}
