"""The port's image-text models and losses against the JAX package's, on
the CPU, at small sizes (f32, 1e-5).

  * the text transformer, at every `pool_type` ("last", "first", "gap",
    "mean", "gmp", "max", "map"), with its tied `vocab_logits`;
  * the two towers (a ViT-mu/16 with `tok` pooling and no head, out_dim
    (0, 16); with and without a bias; with BERT's test config as the text
    tower), from one JAX init carried across by `utils/convert`, and back;
  * `two_towers.load` of per-tower files and of one file (`:img`, `:txt`,
    `:t`, `:b`), with `img_load_kw`/`txt_load_kw` keeping the heads (with
    BERT as the text tower); the text transformer's `load`, which folds a
    posemb stored in the encoder into the top one;
  * the SigLIP loss, `global` and `chunked` (JAX's over a ring of 2
    virtual CPU devices), and its gradients;
  * `bidirectional_contrastive_loss` with and without a mask, reduced and
    per example, and its `ncorrect`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch.models.proj.image_text import text_transformer as t_text
from big_vision_torch.models.proj.image_text import two_towers as t_tt
from big_vision_torch.models.proj.image_text import utils as t_utils
from big_vision_torch.parallel import contrastive as t_con
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_torch.utils import losses as t_losses
from big_vision_torch.utils import trees
from big_vision_tpu.models.proj.image_text import text_transformer as j_text
from big_vision_tpu.models.proj.image_text import two_towers as j_tt
from big_vision_tpu.parallel import contrastive as j_con
from big_vision_tpu.utils import losses as j_losses

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)
IMG = RNG.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
TXT = RNG.integers(1, 64, (4, 8)).astype(np.int32)
TXT[1, 3:] = 0  # a padded caption (BERT masks id 0)
TXT[2, 1:] = 0


def _jax_init(model, *inputs):
  return jax.device_get(jax.jit(model.init)(
      jax.random.PRNGKey(0), *inputs)["params"])


def _close(got, want):
  np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                             **TOL)


@pytest.mark.parametrize("pool", ["last", "first", "gap", "mean", "gmp",
                                  "max", "map"])
def test_text_transformer_matches_jax(pool):
  kw = dict(variant="mu", vocab_size=64, pool_type=pool)
  jm = j_text.Model(16, **kw)
  params = _jax_init(jm, TXT[:1])
  want, jout = jm.apply({"params": params}, TXT)
  tm = t_text.Model(16, **kw, text_len=8, device="cpu")
  convert.load(tm, convert.state(tm, params))
  got, tout = tm(torch.from_numpy(TXT))
  _close(got, want)
  for k in ("pre_logits", "vocab_logits", "transformed"):
    _close(tout[k], jout[k])
  back = trees.flatten(convert.params(tm))
  assert sorted(back) == sorted(trees.flatten(params))
  assert all(np.array_equal(back[k], v)
             for k, v in trees.flatten(params).items())


TOWERS = {
    "transformer": dict(text=dict(variant="mu", vocab_size=64),
                        bias_init=-2.0),
    "transformer_no_bias": dict(text=dict(variant="mu", vocab_size=64)),
    "bert": dict(text_model="proj.flaxformer.bert",
                 text=dict(config="test", vocab_size=64,
                           head_zeroinit=False), bias_init=-2.71),
}


def _towers(name):
  cfg = dict(image=dict(variant="mu/16", pool_type="tok",
                        head_zeroinit=False), out_dim=(0, 16),
             temperature_init=10.0, **TOWERS[name])
  jm = j_tt.Model(**cfg)
  params = _jax_init(jm, IMG[:1], TXT[:1])
  tm = t_tt.Model(**cfg, image_size=32, text_len=8, device="cpu")
  convert.load(tm, convert.state(tm, params))
  return cfg, jm, params, tm


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_two_towers_match_jax(name):
  _, jm, params, tm = _towers(name)
  zimg, ztxt, jout = jm.apply({"params": params}, IMG, TXT)
  with torch.no_grad():
    gi, gt, tout = tm(torch.from_numpy(IMG), torch.from_numpy(TXT))
  _close(gi, zimg)
  _close(gt, ztxt)
  for k in ("t", "t/parameter", "img/norm", "txt/norm", "img/pre_logits"):
    _close(tout[k], jout[k])
  assert ("b" in tout) == ("b" in jout)
  back = trees.flatten(convert.params(tm))
  assert sorted(back) == sorted(trees.flatten(params))
  # Either tower alone.
  with torch.no_grad():
    only_img = tm(torch.from_numpy(IMG))
    only_txt = tm(None, torch.from_numpy(TXT))
  assert only_img[1] is None and only_txt[0] is None
  _close(only_img[0], zimg)
  _close(only_txt[1], ztxt)


@pytest.mark.parametrize("one_file", [False, True])
def test_two_towers_load_matches_jax(tmp_path, one_file):
  # BERT as the text tower: the JAX text transformer's `load` imports
  # flax's checkpoint library (seconds); its port is held below.
  cfg, jm, params, tm = _towers("bert")
  src = jax.tree.map(lambda x: np.asarray(x) + 0.5, params)
  if one_file:
    init, kw = str(tmp_path / "both.npz"), {}
    checkpoints.npz_save(src, init)
  else:
    init = {"image": str(tmp_path / "img.npz"),
            "text": str(tmp_path / "txt.npz")}
    checkpoints.npz_save(src["img"], init["image"])
    checkpoints.npz_save(src["txt"], init["text"])
    kw = dict(img_load_kw={"dont_load": ["head/.*"]},
              txt_load_kw={"dont_load": ["head/.*"]})
  want = j_tt.load(params, init, cfg, **kw)
  got = t_tt.load(convert.params(tm), init, cfg, **kw)
  want, got = trees.flatten(jax.device_get(want)), trees.flatten(got)
  assert sorted(want) == sorted(got)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  if not one_file:  # the scalars stay the init's
    np.testing.assert_array_equal(got["t"], params["t"])


def test_text_transformer_load_folds_a_stray_posemb(tmp_path):
  tm = t_text.Model(16, variant="mu", vocab_size=64, text_len=8,
                    device="cpu")
  tm.initialize(torch.Generator().manual_seed(0))
  params = convert.params(tm)
  src = {**params, "Encoder_0": {**params["Encoder_0"],
                                 "pos_embedding": params["pos_embedding"]}}
  checkpoints.npz_save(src, str(tmp_path / "txt.npz"))
  got = t_text.load(params, str(tmp_path / "txt.npz"), {})
  np.testing.assert_array_equal(got["pos_embedding"],
                                2 * params["pos_embedding"])
  kept = t_text.load(params, str(tmp_path / "txt.npz"), {},
                     dont_load=["head/.*"])
  np.testing.assert_array_equal(kept["head"]["kernel"],
                                params["head"]["kernel"])


def _embeddings(b=16, d=8, seed=1):
  rng = np.random.default_rng(seed)
  z = rng.normal(size=(2, b, d)).astype(np.float32)
  return z / np.linalg.norm(z, axis=-1, keepdims=True)


def test_siglip_losses_and_gradients_match_jax():
  zimg, ztxt = _embeddings()
  t, b = np.float32(10.0), np.float32(-2.0)
  mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
  j_chunked = j_con.siglip_loss_fn(mesh, "data")
  for j_fn, t_fn in ((j_con.global_siglip_loss, t_con.global_siglip_loss),
                     (j_chunked, t_con.siglip_loss_fn())):
    want, jgrads = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1, 2, 3)))(
        jnp.asarray(zimg), jnp.asarray(ztxt), t, b)
    args = [torch.tensor(x, requires_grad=True) for x in (zimg, ztxt, t, b)]
    got = t_fn(*args)
    got.backward()
    _close(got, want)
    for a, g in zip(args, jgrads):
      _close(a.grad, g)
  # On one device the chunked loss is the global one.
  args = [torch.from_numpy(x) for x in (zimg, ztxt)] + [torch.tensor(t),
                                                       torch.tensor(b)]
  torch.testing.assert_close(t_con.siglip_loss_fn()(*args),
                             t_con.global_siglip_loss(*args))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reduction", [False, True])
def test_bidirectional_contrastive_loss_matches_jax(masked, reduction):
  zimg, ztxt = _embeddings(b=6, seed=2)
  ztxt[3] = zimg[3]  # one sure hit
  mask = np.array([1, 1, 0, 1, 1, 0], np.float32) if masked else None
  want, wx = j_losses.bidirectional_contrastive_loss(
      zimg, ztxt, 3.0, mask=mask, reduction=reduction)
  got, gx = t_losses.bidirectional_contrastive_loss(
      torch.from_numpy(zimg), torch.from_numpy(ztxt), 3.0,
      mask=None if mask is None else torch.from_numpy(mask),
      reduction=reduction)
  _close(got, want)
  _close(gx["ncorrect"], wx["ncorrect"])


def test_subsample_batch():
  x = {"a": torch.arange(6), "b": torch.arange(12).reshape(6, 2)}
  out = t_utils.subsample_batch(x, 2)
  assert out["a"].tolist() == [0, 2, 4] and out["b"].shape == (3, 2)
  assert t_utils.subsample_batch(x, 1) is x
