"""Contrastive losses: port of big_vision_tpu/parallel/contrastive.py on
one device.

`global_siglip_loss` is the SigLIP loss over the full [B, B] logits
(`zimg @ ztxt.T * t + b`, +1 labels on the diagonal, -1 off it; the sum of
-log sigmoid over a row, averaged over the rows). `siglip_loss_fn` is the
`chunked` form: the JAX package keeps each device's block resident and
rotates the text shards around the ring, summing -log sigmoid block by
block and dividing by the global batch. On one device the ring has one
member, so it is the resident block alone: the same sum divided by the
batch. The ring over several devices waits for the multi-device port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _sigmoid_nll_block(zimg, ztxt, t, b, positives_diag):
  """Sum of -log sigmoid over one [bl, bl] block of image/text pairs."""
  logits = (zimg @ ztxt.T) * t + b
  if positives_diag:
    signs = 2 * torch.eye(zimg.shape[0], dtype=logits.dtype,
                          device=logits.device) - 1
  else:
    signs = -torch.ones_like(logits)
  return -torch.sum(F.logsigmoid(signs * logits))


def chunked_siglip_loss(zimg, ztxt, t, b):
  """The summed -log sigmoid of this device's rows against the global text
  batch: on one device, its own block."""
  return _sigmoid_nll_block(zimg, ztxt, t, b, positives_diag=True)


def siglip_loss_fn(mesh=None, axis_name="data"):
  """loss(zimg, ztxt, t, b): the mean over the batch of the chunked sum."""
  del mesh, axis_name  # one device

  def loss_fn(zimg, ztxt, t, b):
    return chunked_siglip_loss(zimg, ztxt, t, b) / zimg.shape[0]
  return loss_fn


def global_siglip_loss(zimg, ztxt, t, b):
  """The full [B, B] logits' loss (the reference semantics)."""
  logits = (zimg @ ztxt.T) * t + b
  signs = 2 * torch.eye(zimg.shape[0], dtype=logits.dtype,
                        device=logits.device) - 1
  return -torch.mean(torch.sum(F.logsigmoid(signs * logits), dim=-1))
