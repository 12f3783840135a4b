"""The port's NaFlex tower (SigLIP 2) and its pp ops against the JAX
package's, on the CPU.

pp: `get_image_size_for_seq` bit-equal over sizes, budgets and both
`divisible_by_patch`; `resize_to_sequence` (float32 out) within 1e-6 of
the JAX op, `central_crop_to_sequence`, `patchify`, `tuplify` and the whole
chain with `pad_to_shape` bit-equal.

Model: `pos_emb_resize` against the JAX `_pos_emb_resize` (scale_and_
translate then the filling gather) for grids that shrink, grow and are not
square, within 1e-6 with the NaNs in the same places; a mu tower with
padding at `gap`, `max` and `map` pooling, random weights carried by
`utils/convert.py`: logits within 1e-5 and every gradient within 1e-4 of
its max, on the "xla" path (a [B, T, T] boolean mask) and on "flash"
(segment ids; the JAX Pallas kernels in interpret mode, the port's plain
versions); the flash path's padded query rows exact zeros in the forward
and in dq; padding invariance.

Trainer: a 2-step SigLIP twin of one config dict (siglip_smoke's with a
NaFlex mu tower, images of many aspect ratios): the port's `siglip.Trainer`
against the JAX SigLIP trainer's `update_fn` arithmetic (the JAX model,
`global_siglip_loss`, `optim.make`, optax), on the same batches of the
port's input pipeline. The JAX trainer itself cannot take a NaFlex
image: its `init_shapes` dummy is one array and its `_collate` cannot
stack a tuple.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from big_vision_torch.configs.proj.image_text import siglip_smoke as t_smoke
from big_vision_torch.models.proj.image_text import naflex_vit as t_nv
from big_vision_torch.ops import attention as t_attn
from big_vision_torch.pp import builder as t_builder
from big_vision_torch.pp.proj.image_text import ops_naflex as t_ops
from big_vision_torch.trainers.proj.image_text import siglip as t_siglip
from big_vision_torch.utils import convert
from big_vision_tpu import optim as j_optim
from big_vision_tpu.models.proj.image_text import naflex_vit as j_nv
from big_vision_tpu.models.proj.image_text import two_towers as j_tt
from big_vision_tpu.parallel import contrastive as j_con
from big_vision_tpu.pp import builder as j_builder
from big_vision_tpu.pp.proj.image_text import ops_naflex as j_ops
import big_vision_tpu.pp.ops_general  # noqa: F401
import big_vision_tpu.pp.ops_image  # noqa: F401
import big_vision_torch.pp.ops_general  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("divisible", [True, False])
def test_size_for_seq_equals_jax(divisible):
  for hw in [(480, 640), (96, 512), (512, 96), (33, 47), (16, 16),
             (1000, 7)]:
    for budget in (16, 64, 256):
      want = j_ops.get_image_size_for_seq(hw, 16, budget, divisible)
      got = t_ops.get_image_size_for_seq(hw, 16, budget, divisible)
      assert got == want, (hw, budget, got, want)


def _chain(seq=24, p=8):
  return (f"resize_to_sequence({p}, {seq})|value_range(-1, 1)"
          f"|patchify({p})|flatten"
          f"|pad_to_shape(({seq}, {p * p * 3}), key='image/patches')"
          f"|pad_to_shape(({seq},), key='image/type')"
          f"|pad_to_shape(({seq},), key='image/yidx')"
          f"|pad_to_shape(({seq},), key='image/xidx')"
          "|tuplify(['image/patches', 'image/type', 'image/yidx', "
          "'image/xidx'], 'image')")


def test_pp_ops_equal_jax():
  rs = np.random.RandomState(0)
  for h, w in [(100, 140), (37, 90), (64, 20)]:
    img = rs.randint(0, 255, (h, w, 3), np.uint8)
    for spec in ("resize_to_sequence(8, 24)", "resize_to_sequence(8, 24, "
                 "divisible_by_patch=False)"):
      want = j_builder.get_preprocess_fn(spec).host(
          {"image": img}, np.random.default_rng(0))["image"]
      got = t_builder.get_preprocess_fn(spec).host(
          {"image": img}, np.random.default_rng(0))["image"]
      assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
      np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 255)
    crop = ("central_crop_to_sequence(8, 24)",) if w > 20 else ()
    for spec in crop + ("patchify(8)", "patchify((4, 8))"):
      want = j_builder.get_preprocess_fn(spec).host(
          {"image": img}, np.random.default_rng(0))["image"]
      got = t_builder.get_preprocess_fn(spec).host(
          {"image": img}, np.random.default_rng(0))["image"]
      for k in (want if isinstance(want, dict) else {"": 0}):
        a, b = (want[k], got[k]) if k else (want, got)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    want = j_builder.get_preprocess_fn(_chain()).host(
        {"image": img}, np.random.default_rng(0))["image"]
    got = t_builder.get_preprocess_fn(_chain()).host(
        {"image": img}, np.random.default_rng(0))["image"]
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
      assert a.dtype == b.dtype and a.shape == b.shape
      np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    assert got[1].sum() <= 24 and (got[1][got[1].sum():] == 0).all()


def _grid_coords(grids, t):
  out = []
  for gh, gw in grids:
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    c = np.stack([yy.ravel(), xx.ravel()], -1)
    out.append(np.pad(c, ((0, t - len(c)), (0, 0))))
  return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("grids,l", [
    ([(2, 2), (3, 1)], 6),     # shrink (table 5x4)
    ([(9, 8), (12, 12)], 12),  # grow
    ([(3, 11), (10, 2)], 12),  # not square, one side grows, one shrinks
    ([(3, 11), (10, 2)], 8),   # past the bound: the gather's NaN fill
])
def test_pos_emb_resize_equals_jax(grids, l):
  table = np.random.RandomState(1).randn(5, 4, 6).astype(np.float32)
  coords = _grid_coords(grids, 144)
  shapes = coords.max(1) + 1
  want = np.asarray(j_nv._pos_emb_resize(
      jnp.asarray(table), jnp.asarray(shapes), jnp.asarray(coords), l))
  got = t_nv.pos_emb_resize(torch.from_numpy(table),
                            torch.from_numpy(shapes).long(),
                            torch.from_numpy(coords).long(), l).numpy()
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                             rtol=1e-6, atol=1e-6)


def _inputs(b=3, t=20, seed=0):
  """A padded NaFlex batch: grids 3x5, 4x4 and 2x7 patch tokens of 8x8x3,
  the rest of the 20 slots padding (type 0, coords 0)."""
  rs = np.random.RandomState(seed)
  patches = rs.randn(b, t, 8 * 8 * 3).astype(np.float32)
  grids = [(3, 5), (4, 4), (2, 7)][:b]
  coords = _grid_coords(grids, t)
  ptype = np.zeros((b, t), np.int32)
  for i, (gh, gw) in enumerate(grids):
    ptype[i, :gh * gw] = 1
  return patches, ptype, coords[..., 0], coords[..., 1]


def _random_params(model, x, seed=0, scale=0.3):
  shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
  rs = np.random.RandomState(seed)
  return jax.tree.map(
      lambda s: (rs.randn(*s.shape) * scale).astype(np.float32),
      shapes["params"])


@pytest.mark.parametrize("pool,impl", [("gap", "xla"), ("max", "xla"),
                                       ("map", "xla"), ("map", "flash")])
def test_tower_and_gradients_equal_jax(pool, impl):
  cfg = dict(variant="mu", depth=2, nposemb=4, posemb="learn_2d(8)",
             pool_type=pool, attn_impl=impl)
  x = _inputs()
  jx = tuple(jnp.asarray(a) for a in x)
  jmodel = j_nv.Model(num_classes=6, **cfg)
  params = _random_params(jmodel, jx)
  labels = np.eye(6, dtype=np.float32)[[1, 4, 2]]

  def loss_fn(p):
    logits, _ = jmodel.apply({"params": p}, jx)
    return jnp.sum(logits * labels) + 0.1 * jnp.sum(logits ** 2), logits
  (_, want_logits), want = jax.jit(jax.value_and_grad(loss_fn,
                                                   has_aux=True))(params)

  tmodel = t_nv.Model(num_classes=6, patch_size=8, device="cpu", **cfg)
  convert.load(tmodel, convert.state(tmodel, params))
  want = convert.state(tmodel, jax.device_get(want))
  tx = tuple(torch.from_numpy(a) for a in x)
  logits, _ = tmodel(tx)
  loss = (logits * torch.from_numpy(labels)).sum() + 0.1 * (logits ** 2).sum()
  loss.backward()
  np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                             rtol=1e-5, atol=1e-5)
  for name, p in tmodel.named_parameters():
    w, g = want[name], p.grad.numpy()
    top = max(np.abs(w).max(), 1e-3 * max(np.abs(v).max()
                                          for v in want.values()))
    assert np.abs(g - w).max() <= 1e-4 * top, name

  # Padding invariance: what the padded slots hold changes nothing.
  noisy = (tx[0] + 5.0 * (tx[1] == 0)[..., None].float(),) + tx[1:]
  with torch.no_grad():
    again, _ = tmodel(noisy)
  np.testing.assert_allclose(again.numpy(), logits.detach().numpy(),
                             rtol=1e-5, atol=1e-5)


def test_flash_seg_equals_the_bool_mask_with_zero_padded_rows():
  cfg = dict(variant="mu", depth=2, nposemb=4, posemb="learn_2d(8)",
             pool_type="map")
  x = tuple(torch.from_numpy(a) for a in _inputs())
  models = {}
  for impl in ("xla", "flash"):
    m = t_nv.Model(num_classes=6, patch_size=8, attn_impl=impl, device="cpu",
                   **cfg)
    m.initialize(torch.Generator().manual_seed(0))
    models[impl] = m
  models["flash"].load_state_dict(models["xla"].state_dict())
  with torch.no_grad():
    lx, _ = models["xla"](x)
    lf, _ = models["flash"](x)
  np.testing.assert_allclose(lf.numpy(), lx.numpy(), rtol=1e-5, atol=1e-5)

  # The kernels' contract on padding: a query row with seg 0 sees no key,
  # and its output and dq are exact zeros.
  g = torch.Generator().manual_seed(3)
  q, k, v = (torch.randn(3, 20, 2, 16, generator=g, requires_grad=True)
             for _ in range(3))
  seg = x[1]
  o = t_attn.dot_product_attention(q, k, v, impl="flash", seg=seg)
  o.backward(torch.randn(o.shape, generator=g))
  pad = seg == 0
  assert pad.any()
  assert torch.all(o.detach()[pad] == 0)
  assert torch.all(q.grad[pad] == 0)
  assert torch.all(k.grad[pad] == 0) and torch.all(v.grad[pad] == 0)


def _twin_config(steps=10):
  seq, p = 16, 8
  config = t_smoke.get_config(f"total_steps={steps},batch_size=8,"
                              "loss_impl=global")
  config["input"]["data"] = dict(name="synthetic", n=32, num_classes=8,
                                 h=40, w=40, side_range=(24, 72))
  config["input"]["pp"] = (
      "decode|" + _chain(seq, p)
      + "|strfmt('photo number {label}', outkey='text')"
      "|tokenize(8, eos='sticky', model='test(128)', pad_value=1, "
      "inkey='text', outkey='labels')|keep('image', 'labels')")
  config["pp_modules"] = ["ops_general", "ops_image", "ops_text",
                          "proj.image_text.ops_naflex"]
  config["init_shapes"] = [(1, seq, p * p * 3), (1, 8)]
  config["model"]["image_model"] = "proj.image_text.naflex_vit"
  config["model"]["image"] = dict(variant="mu", nposemb=4,
                                  posemb=f"learn_2d({seq})", pool_type="map",
                                  patch_size=p, head_zeroinit=False)
  config["evals"] = {}
  return config


def test_siglip_naflex_twin_tracks_the_jax_update():
  config = _twin_config()
  trainer = t_siglip.Trainer(config, device="cpu")
  params = jax.tree.map(jnp.asarray, convert.params(trainer.model))
  jcfg = dict(config["model"])
  jcfg["image"] = {k: v for k, v in jcfg["image"].items()
                   if k != "patch_size"}
  jmodel = j_tt.Model(**jcfg)
  tx, _ = j_optim.make(config, params, sched_kw=dict(
      total_steps=trainer.total_steps, batch_size=8, data_size=32))
  opt = tx.init(params)

  @jax.jit
  def update(params, opt, batch):
    def loss_fn(p):
      zimg, ztxt, out = jmodel.apply({"params": p}, batch["image"],
                                     batch["labels"], train=True)
      return j_con.global_siglip_loss(zimg, ztxt, out["t"][0],
                                      out["b"][0])
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt = tx.update(grads, opt, params)
    return (optax.apply_updates(params, updates), opt,
            {"training_loss": loss, "l2_grads": optax.global_norm(grads)})

  it = trainer.input_iter(0)
  worst = 0.0
  for _ in range(2):
    batch = next(it)
    assert isinstance(batch["image"], tuple) and len(batch["image"]) == 4
    assert (batch["image"][1] == 0).any()  # some examples carry padding
    jbatch = {"image": tuple(jnp.asarray(a.numpy()) for a in batch["image"]),
              "labels": jnp.asarray(batch["labels"].numpy())}
    params, opt, want = update(params, opt, jbatch)
    got = trainer.update(batch)
    for key in want:
      w, g = float(want[key]), float(got[key])
      worst = max(worst, abs(g - w) / abs(w))
  it.close()
  assert worst <= 1e-4, worst
  tparams = convert.params(trainer.model)
  flat_w = dict(jax.tree_util.tree_flatten_with_path(params)[0])
  for path, w in flat_w.items():
    g = tparams
    for p in path:
      g = g[p.key]
    name = "/".join(p.key for p in path)
    if name.endswith("key/bias"):
      # Its gradient is zero in exact arithmetic (a key bias shifts a whole
      # row of logits, which the softmax ignores); Adam turns each side's
      # rounding noise into steps of the lr's size.
      continue
    np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5,
                               err_msg=name)
