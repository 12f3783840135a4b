"""Port's BiT (`models/bit.py`, `models/bit_paper.py`, `models/convnets.py`)
vs the JAX models.

Both flavours at depth 26, width 0.5 and 64 px (even sides: JAX's SAME
pads the 7x7/2 root conv (2, 3) and the 3x3/2 convs (0, 1)) on two images,
with the same params on both sides: the port's init from a seed, with
every GroupNorm scale and bias (each unit's zero-init gn3 too) and the
head drawn, so that no branch and no logit is zero. Logits and every tap
agree within 1e-5 relative in f32, also at an odd side (65 px, where
every SAME pad is symmetric) and at 224 px on one image (where the root
conv pads (2, 3)). The gradient of every param agrees within 1e-5
relative in f64 on both sides: in f32 a relu's mask flips where an input
lies within rounding of zero, which moves a gradient by a whole term (see
`test_gradients_match_jax`). The layers alone: WSConv in both
standardisations (and none) at kernels 1, 3 and 7, strides 1 and 2, SAME
and explicit paddings; GroupNorm in both flavours. The JAX WS-invariance
test is mirrored: a root kernel scaled by 10 gives the same output.
`load` and the converter are held in `tests/test_torch_bit_load.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models import bit as t_bit
from big_vision_torch.models import bit_paper as t_bit_paper
from big_vision_torch.models import convnets as t_cn
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees as t_trees
from big_vision_tpu.models import bit as j_bit
from big_vision_tpu.models import bit_paper as j_bit_paper
from big_vision_tpu.models import convnets as j_cn

DEPTH, WIDTH, CLASSES = 26, 0.5, 10
MODULES = {"bit": (t_bit, j_bit), "bit_paper": (t_bit_paper, j_bit_paper)}


def _rel(got, want):
  want = np.asarray(want)
  return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                     1e-30)


def _port(flavour, seed=0):
  """The port's model from a seed, with every GN param and the head drawn
  around their inits."""
  model = MODULES[flavour][0].Model(
      num_classes=CLASSES, depth=DEPTH, width=WIDTH, device="cpu")
  model.initialize(torch.Generator().manual_seed(seed))
  gen = torch.Generator().manual_seed(seed + 1)
  with torch.no_grad():
    for name, p in model.named_parameters():
      layer = model.get_submodule(name.rsplit(".", 1)[0])
      if isinstance(layer, t_cn.GroupNorm):
        p.add_(0.3 * torch.randn(p.shape, generator=gen))
    model.head.weight.normal_(0.0, 0.1, generator=gen)
    model.head.bias.normal_(0.0, 0.1, generator=gen)
  return model


def _jax(flavour):
  return MODULES[flavour][1].Model(num_classes=CLASSES, depth=DEPTH,
                                   width=WIDTH)


def _images(n, res, seed=2):
  return np.random.RandomState(seed).uniform(
      -1, 1, (n, res, res, 3)).astype(np.float32)


def _jit(f, *args):
  """`f(*args)`, compiled by XLA at its lowest backend optimisation level:
  the same function, and compiling it is most of this file's time."""
  return jax.jit(f).lower(*args).compile(
      compiler_options={"xla_backend_optimization_level": 0})(*args)


def _check_taps(jout, tout):
  jflat, tflat = t_trees.flatten(dict(jout)), t_trees.flatten(tout)
  assert sorted(jflat) == sorted(tflat)
  for name, want in jflat.items():
    assert tflat[name].shape == want.shape, name
    assert _rel(tflat[name].detach(), want) <= 1e-5, (
        name, _rel(tflat[name].detach(), want))


@pytest.mark.parametrize("flavour,res,n", [
    ("bit_paper", 64, 2), ("bit", 65, 2), ("bit", 224, 1)])
def test_logits_and_taps_match_jax(flavour, res, n):
  tmodel = _port(flavour)
  images = _images(n, res)
  jout = _jit(lambda p, x: _jax(flavour).apply({"params": p}, x)[1],
              convert.params(tmodel), jnp.asarray(images))
  with torch.no_grad():
    _, tout = tmodel(torch.from_numpy(images))
  _check_taps(jout, tout)
  assert np.abs(np.asarray(jout["logits"])).min() > 0


@pytest.mark.parametrize("flavour", ["bit", "bit_paper"])
def test_gradients_match_jax(flavour):
  # In f64 on both sides: some relu inputs lie within f32 rounding of zero,
  # so f32 rounding flips a relu's mask now and then, and a flip moves a
  # gradient by a whole position's term (1-8% on bit_paper at this seed,
  # where the JAX package's own eager and jitted f32 gradients differ by as
  # much).
  tmodel = _port(flavour).double()
  jmodel = _jax(flavour)
  images = _images(2, 64).astype(np.float64)
  weights = np.random.RandomState(3).randn(2, CLASSES)

  def jloss(p):
    logits, out = jmodel.apply({"params": p}, jnp.asarray(images))
    return jnp.sum(logits * weights), out

  with jax.enable_x64(True):
    params = jax.tree.map(np.float64, convert.params(tmodel))
    (_, jout), jgrads = _jit(jax.value_and_grad(jloss, has_aux=True),
                             params)
    jout, jgrads = jax.device_get((jout, jgrads))
  tlogits, tout = tmodel(torch.from_numpy(images))
  (tlogits * torch.from_numpy(weights)).sum().backward()
  _check_taps(jout, tout)
  grads = {n: p.grad for n, p in tmodel.named_parameters()}
  tgrads = t_trees.flatten(convert._params(
      tmodel, convert.names(tmodel),
      lambda m, n, j, x: convert._bit_layout(m, n, j, grads[n])))
  jflat = t_trees.flatten(jgrads)
  assert sorted(tgrads) == sorted(jflat)
  for name, want in jflat.items():
    assert want.dtype == np.float64 and np.abs(want).max() > 0, name
    assert _rel(tgrads[name], want) <= 1e-5, (name, _rel(tgrads[name], want))


def test_same_padding_is_jax_s():
  assert t_cn.same_padding(224, 7, 2) == (2, 3)
  assert t_cn.same_padding(56, 3, 2) == (0, 1)
  assert t_cn.same_padding(112, 3, 2) == (0, 1)
  assert t_cn.same_padding(65, 7, 2) == (3, 3)
  assert t_cn.same_padding(56, 3, 1) == (1, 1)
  assert t_cn.same_padding(7, 1, 2) == (0, 0)


@pytest.mark.parametrize("ws,eps,ksize,strides,res,padding", [
    ("std", 1e-5, 3, 2, 16, "SAME"), ("std", 1e-5, 7, 2, 18, "SAME"),
    ("std", 1e-5, 3, 1, 15, "SAME"), ("std", 1e-5, 1, 2, 9, "SAME"),
    ("rms", 1e-10, 3, 2, 16, [(1, 1), (1, 1)]),
    ("rms", 1e-10, 7, 2, 17, [(3, 3), (3, 3)]),
    ("rms", 1e-10, 3, 2, 16, "SAME"), (None, 1e-5, 7, 2, 18, "SAME")])
def test_wsconv_matches_jax(ws, eps, ksize, strides, res, padding):
  cin, cout = 64, 8
  conv = t_cn.WSConv(cin, cout, ksize, strides, padding=padding, ws=ws,
                     eps=eps, device="cpu")
  conv.reset_parameters(torch.Generator().manual_seed(0))
  x = np.random.RandomState(4).randn(2, res, res, cin).astype(np.float32)
  with torch.no_grad():
    got = conv(torch.from_numpy(x))
  kernel = conv.weight.detach().permute(2, 3, 1, 0).numpy()
  want = j_cn.WSConv(cout, ksize, strides, padding=padding, ws=ws,
                     eps=eps).apply({"params": {"kernel": kernel}},
                                    jnp.asarray(x))
  assert got.shape == want.shape
  assert _rel(got, want) <= 1e-5, _rel(got, want)


@pytest.mark.parametrize("msq,eps", [(False, 1e-6), (True, 1e-5)])
def test_groupnorm_matches_jax(msq, eps):
  c = 64
  x = 3.0 + np.random.RandomState(5).randn(2, 7, 7, c).astype(np.float32)
  gn = t_cn.GroupNorm(c, msq=msq, eps=eps, device="cpu")
  gen = torch.Generator().manual_seed(6)
  with torch.no_grad():
    gn.weight.normal_(1.0, 0.3, generator=gen)
    gn.bias.normal_(0.0, 0.3, generator=gen)
    got = gn(torch.from_numpy(x))
  shape = (1, 1, 1, c) if msq else (c,)
  want = j_cn.GroupNorm(msq=msq, eps=eps).apply(
      {"params": {"scale": gn.weight.detach().numpy().reshape(shape),
                  "bias": gn.bias.detach().numpy().reshape(shape)}},
      jnp.asarray(x))
  assert _rel(got, want) <= 1e-5, _rel(got, want)


@pytest.mark.parametrize("flavour", ["bit", "bit_paper"])
def test_root_kernel_scale_leaves_the_output_unchanged(flavour):
  tmodel = _port(flavour)
  x = torch.from_numpy(_images(1, 32))
  with torch.no_grad():
    y0, _ = tmodel(x)
    root = (tmodel.conv_root if flavour == "bit"
            else tmodel.root_block.conv_root)
    root.weight.mul_(10.0)
    y1, _ = tmodel(x)
  np.testing.assert_allclose(y0.numpy(), y1.numpy(), rtol=1e-4, atol=1e-4)
