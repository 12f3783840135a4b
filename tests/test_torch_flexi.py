"""Port's FlexiViT (models/proj/flexi/vit.py) vs the JAX model on the CPU.

Kernel and posemb resizes against the JAX package's `resample_patchemb`
and `jax.image.resize(..., "linear")`; then a tiny FlexiViT (width 32,
depth 2, 2 heads, 24px, stored patch 8x8, posemb 3x3, tok pool) built from
the JAX init through `convert.vit`: logits and gradients at several token
grids, in f32 within 1e-5 of max|x|, first with each package's own
attention dispatch (both packages' "auto" take the plain path below T=16
and the one-shot kernel above, the port's its plain version), then with
the blocked path inside the model on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.proj.flexi import vit as t_flexi
from big_vision_torch.ops import attention as t_attention
from big_vision_torch.ops import flash_attention as t_flash
from big_vision_torch.utils import convert
from big_vision_tpu.models.proj.flexi import vit as j_flexi
from big_vision_tpu.ops import attention as j_attention
from big_vision_tpu.ops import flash_attention as j_flash

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(width=32, depth=2, num_heads=2, mlp_dim=64, pool_type="tok",
            patch_size=(8, 8), posemb_size=(3, 3))


def _close(got, want, bar=1e-5):
  got = got.detach().float().numpy() if torch.is_tensor(got) else got
  want = np.asarray(want, np.float32)
  scale = max(1e-30, float(np.abs(want).max()))
  assert got.shape == want.shape, (got.shape, want.shape)
  assert np.abs(got - want).max() <= bar * scale, (
      np.abs(got - want).max() / scale, bar)


def _to_port(kernel):
  """JAX patch kernel [h, w, c, width] -> the port's [width, h*w*c]."""
  return torch.from_numpy(np.asarray(kernel).reshape(-1, kernel.shape[-1]).T
                          .copy())


@pytest.mark.parametrize("new_hw", [(4, 4), (12, 12), (5, 7)])
def test_resample_patchemb_matches_jax(new_hw):
  k = np.random.RandomState(0).randn(8, 8, 3, 16).astype(np.float32)
  want = np.asarray(j_flexi.resample_patchemb(k, new_hw))
  got = t_flexi.resample_patchemb(_to_port(k), (8, 8), new_hw)
  _close(got, _to_port(want).numpy())


def test_resample_patchemb_pi_property():
  """<k, patch> ~ <resample(k), resize(patch)> (tests/test_more_models.py)."""
  rs = np.random.RandomState(0)
  k = rs.randn(4, 4, 1, 1).astype(np.float32)
  patch = rs.randn(4, 4).astype(np.float32)
  k8 = t_flexi.resample_patchemb(_to_port(k), (4, 4), (8, 8))
  patch8 = np.asarray(jax.image.resize(patch, (8, 8), "linear"))
  want = float(np.sum(k[..., 0, 0] * patch))
  got = float(np.sum(k8.numpy().reshape(8, 8) * patch8))
  assert got == pytest.approx(want, rel=0.05)
  same = _to_port(k)
  assert t_flexi.resample_patchemb(same, (4, 4), (4, 4)) is same


@pytest.mark.parametrize("new", [5, 6, 40])
def test_posemb_resize_matches_jax_image_resize(new):
  pos = np.random.RandomState(1).randn(1, 49, 8).astype(np.float32)
  want = jax.image.resize(pos.reshape(1, 7, 7, 8), (1, new, new, 8),
                          "linear").reshape(1, new * new, 8)
  got = t_flexi.resize_posemb(torch.from_numpy(pos), (7, 7), (new, new))
  _close(got, want)


def _models():
  jmodel = j_flexi.Model(10, **TINY)
  params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 24, 24, 3)))
  params = jax.device_get(params["params"])
  rs = np.random.RandomState(2)  # a head that passes gradients to the trunk
  params["head"]["kernel"] = 0.1 * rs.randn(
      *params["head"]["kernel"].shape).astype(np.float32)
  tmodel = t_flexi.Model(10, device="cpu", **TINY)
  convert.load(tmodel, convert.vit(params))
  return jmodel, params, tmodel


def _check_model(seqhws):
  jmodel, params, tmodel = _models()
  rs = np.random.RandomState(3)
  images = rs.randn(2, 24, 24, 3).astype(np.float32)
  w = rs.randn(2, 10).astype(np.float32)
  names = convert.vit_names(tmodel)
  for seqhw in seqhws:
    def loss_fn(p):
      logits, _ = jmodel.apply({"params": p}, images, seqhw=seqhw)
      return jnp.sum(logits * w), logits
    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    grads = convert.vit(jax.device_get(grads))
    tmodel.zero_grad()
    logits, out = tmodel(torch.from_numpy(images), seqhw=seqhw)
    assert out["encoded"].shape == (2, seqhw * seqhw + 1, 32)
    (logits * torch.from_numpy(w)).sum().backward()
    _close(logits, want)
    for name, p in tmodel.named_parameters():
      if name.endswith("attn.key.bias"):  # rounding noise: zero exactly
        continue
      assert name in names
      _close(p.grad, grads[name])


def test_tiny_flexivit_matches_jax():
  _check_model((2, 3, 4, 6))


def test_tiny_flexivit_blocked_path_matches_jax(monkeypatch):
  """seqhw 4 and 6 (T = 17 and 37 >= 16, JAX's `supports` gate) with the
  one-shot path switched off in both packages and both packages' "auto"
  sent to the fused kernel: the blocked semantics inside the model on both
  sides."""
  monkeypatch.setattr(j_flash, "oneshot_fits", lambda *a: False)
  monkeypatch.setattr(t_flash, "oneshot_fits", lambda *a: False)
  monkeypatch.setattr(j_attention, "XLA_SCORES_BYTES_LIMIT", 0)
  monkeypatch.setattr(t_attention, "XLA_SCORES_BYTES_LIMIT", 0)
  calls = {"jax": 0, "port": 0}

  def counted(side, fn):
    def wrapped(*args):
      calls[side] += 1
      return fn(*args)
    return wrapped
  monkeypatch.setattr(j_flash, "_attend", counted("jax", j_flash._attend))
  monkeypatch.setattr(t_flash._FlashAttentionBlocked, "apply", counted(
      "port", t_flash._FlashAttentionBlocked.apply))
  _check_model((4, 6))
  assert calls == {"jax": 2 * 2, "port": 2 * 2}  # two layers, two grids


def test_seqhw_is_required():
  tmodel = t_flexi.Model(10, device="cpu", **TINY)
  with pytest.raises(ValueError, match="seqhw"):
    tmodel(torch.zeros((1, 24, 24, 3)))
