"""Loss functions: port of `onehot`, `sigmoid_xent`, `softmax_xent`,
`weighted_softmax_xent` and `bidirectional_contrastive_loss` in
big_vision_tpu/utils/losses.py, with the same signatures."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def onehot(labels, num_classes, *, on_value=1.0, off_value=0.0):
  """[..., num_classes] f32: on_value where the class is the label."""
  hit = labels[..., None] == torch.arange(num_classes, device=labels.device)
  return torch.where(hit, on_value, off_value).to(torch.float32)


def sigmoid_xent(*, logits, labels, reduction=True):
  """Multi-label sigmoid cross-entropy, summed over classes."""
  nll = -torch.sum(labels * F.logsigmoid(logits)
                   + (1.0 - labels) * F.logsigmoid(-logits), dim=-1)
  return nll.mean() if reduction else nll


def softmax_xent(*, logits, labels, reduction=True, kl=False, axis=-1):
  """Softmax cross-entropy against (soft) labels; with `kl`, the KL
  divergence instead (the labels' own entropy added back)."""
  nll = -torch.sum(labels * torch.log_softmax(logits, dim=axis), dim=axis)
  if kl:
    nll = nll + torch.sum(labels * torch.log(labels.clamp_min(1e-8)),
                          dim=axis)
  return nll.mean() if reduction else nll


def weighted_softmax_xent(*, logits, labels, reduction=True, weights=None,
                          label_smoothing=0.0, normalize=True):
  """Per-sequence weighted CE of [batch, length, vocab] logits against int
  ids [batch, length]; the smoothed targets are 1 - s at the label and
  s / (vocab - 1) elsewhere, `weights` masks tokens and `normalize`
  divides each sequence's sum by its token count (the weights' sum,
  clipped at 2e-38). Computed without the [batch, length, vocab]
  targets: sum_v target_v * logp_v from the label's log-probability and
  the sum over the vocab."""
  if logits.dim() != labels.dim() + 1:
    raise ValueError(f"Bad shapes: logits {tuple(logits.shape)} labels "
                     f"{tuple(labels.shape)}")
  vocab = logits.shape[-1]
  logp = torch.log_softmax(logits.float(), dim=-1)
  label_logp = logp.gather(-1, labels.long()[..., None])[..., 0]
  if label_smoothing > 0:
    off = label_smoothing / (vocab - 1)
    loss = -(off * logp.sum(-1) + (1.0 - label_smoothing - off) * label_logp)
  else:
    loss = -label_logp
  del logp
  norm = labels.shape[1]
  if weights is not None:
    loss = loss * weights
    norm = weights.sum(dim=1).clamp_min(2e-38)
  loss = loss.sum(dim=1)
  if normalize:
    loss = loss / norm
  return loss.mean() if reduction else loss


def bidirectional_contrastive_loss(zimg, ztxt, t, mask=None,
                                   reduction=False):
  """InfoNCE in both directions over the full [B, B] logits `zimg @ ztxt.T
  * t`; rows and columns of examples outside `mask` are -inf and their
  losses 0. Returns (loss, {"ncorrect": image->text top-1 hits}), per
  example or (with `reduction`) their (masked) mean."""
  logits = (zimg @ ztxt.T) * t
  if mask is not None:
    exclude = ~mask.bool()
    exclude = exclude[:, None] | exclude[None, :]
    logits = torch.where(exclude, float("-inf"), logits)
  l1 = -torch.diagonal(torch.log_softmax(logits, dim=1))  # image -> text
  l2 = -torch.diagonal(torch.log_softmax(logits, dim=0))  # text -> image
  loss = 0.5 * (l1 + l2)
  if mask is not None:
    loss = torch.where(mask.bool(), loss, 0.0)

  def redux(x):
    if not reduction:
      return x
    if mask is None:
      return x.mean()
    return torch.sum(x * mask) / (torch.sum(mask) + 1e-8)
  hits = (logits.argmax(dim=1) == torch.arange(
      len(logits), device=logits.device)).to(torch.float32)
  return redux(loss), {"ncorrect": redux(hits)}
