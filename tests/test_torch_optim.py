"""Port's optimizer, schedules and losses vs the JAX package's.

`optim.make` runs 5 updates of fixed, seeded gradients on both sides from
the same params; the config has a bf16 first moment, a weight-decay mask,
global-norm clipping (small enough to trigger), an lr_mults rule and a
frozen (None) schedule entry. Params and the Adam moments agree within
1e-6 relative to their scale (f32 arithmetic in the same order; pow and
sqrt may differ in the last bit); the bf16 first moment within one bf16
rounding step.

The other rules the JAX configs name (`big_vision.momentum_hp`,
`big_vision.scale_by_adafactor`, `big_vision.sgd`) take the same 5 steps
on params whose kernels are large enough for Adafactor to factor, with a
frozen param, an lr_mults rule and weight decay: params within 1e-6
relative, f32 states within 1e-6, bf16 states within one bf16 ulp.
The block-RMS clip is held with an f32 momentum: its mean over a whole
kernel sums in another order than XLA's, and with a bf16 momentum that
last-bit difference now and then rounds one entry of the state to its
neighbouring bf16 value, which moves that param by 2^-8 of an update.
Adafactor runs on the JAX layout, and also on the port's (kernels stored
[out, in]) through `jax_shapes`. `grad_clip_per_example` clips along the
leading axis that every gradient shares, as JAX's does.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from big_vision_torch import optim as t_optim
from big_vision_torch.utils import losses as t_losses
from big_vision_torch.utils import schedules as t_schedules
from big_vision_torch.utils import trees as t_trees
from big_vision_tpu import optim as j_optim
from big_vision_tpu.utils import losses as j_losses
from big_vision_tpu.utils import schedules as j_schedules
from big_vision_tpu.utils import trees as j_trees

SHAPES = {"embedding/kernel": (4, 4, 3, 8), "embedding/bias": (8,),
          "Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel": (8, 16),
          "Transformer/encoderblock_0/MlpBlock_0/Dense_0/bias": (16,),
          "Transformer/encoder_norm/scale": (8,),
          "head/kernel": (8, 5), "head/bias": (5,)}

CONFIG = dict(
    optax_name="scale_by_adam", optax=dict(mu_dtype="bfloat16"),
    lr=0.01, wd=0.1, grad_clip_norm=2.0,
    lr_mults=[("head/.*", 3.0)],
    schedule=[("embedding/.*", None),
              (".*/bias", dict(warmup_steps=2, decay_type="linear")),
              (".*", dict(warmup_steps=1, decay_type="cosine", mult=0.5))],
)


def _close(got, want, rtol):
  want = np.asarray(want, np.float32)
  got = got.detach().float().numpy()
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rtol * max(1e-30, np.abs(want).max()))


def test_adam_chain_matches_optax():
  rs = np.random.RandomState(0)
  params = {n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
  grads = [{n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
           for _ in range(5)]
  sched_kw = dict(total_steps=10, batch_size=8, data_size=100)

  jparams = j_trees.tree_unflatten(params.items())
  tx, _ = j_optim.make(CONFIG, jparams, sched_kw=sched_kw)
  jstate = tx.init(jparams)
  tparams = {n: torch.from_numpy(x.copy()) for n, x in params.items()}
  ttx, _ = t_optim.make(CONFIG, tparams, sched_kw=sched_kw)
  tstate = ttx.init(tparams)
  for g in grads:
    updates, jstate = tx.update(j_trees.tree_unflatten(g.items()), jstate,
                                jparams)
    jparams = optax.apply_updates(jparams, updates)
    _, tstate = ttx.apply_(tparams, {n: torch.from_numpy(x)
                                     for n, x in g.items()}, tstate)

  want = dict(j_trees.tree_flatten_with_names(jparams)[0])
  for n in SHAPES:
    _close(tparams[n], want[n], 1e-6)
  assert t_optim.get_count(tstate) == j_optim.get_count(jstate) == 5
  (adam,) = j_optim.find_states(jstate, optax.ScaleByAdamState)
  mu = dict(j_trees.tree_flatten_with_names(adam.mu)[0])
  nu = dict(j_trees.tree_flatten_with_names(adam.nu)[0])
  assert sorted(tstate["mu"]) == [n for n in sorted(SHAPES)
                                  if not n.startswith("embedding/")]
  for n in tstate["mu"]:
    assert tstate["mu"][n].dtype == torch.bfloat16
    _close(tstate["mu"][n], np.asarray(mu[n], np.float32), 2 ** -8)
    _close(tstate["nu"][n], nu[n], 1e-6)
  for n in ("embedding/kernel", "embedding/bias"):  # frozen: unchanged
    np.testing.assert_array_equal(tparams[n].numpy(), params[n])


@pytest.mark.parametrize("optax_name", [
    "scale_by_adam", "big_vision.momentum_hp",
    "big_vision.scale_by_adafactor"])
def test_a_step_makes_no_tensor_from_a_host_value(monkeypatch, optax_name):
  """On the card, each tensor made from a host value copies it and waits
  for the stream; a step makes none once the rule's scalars exist."""
  rs = np.random.RandomState(0)
  params = {n: torch.from_numpy(rs.randn(*s).astype(np.float32))
            for n, s in SHAPES.items()}
  config = dict(CONFIG, optax_name=optax_name, optax={})
  tx, _ = t_optim.make(config, params, sched_kw=dict(
      total_steps=10, batch_size=8, data_size=100))
  state = tx.init(params)
  grads = {n: torch.ones_like(p) for n, p in params.items()}
  _, state = tx.apply_(params, grads, state)
  made = []
  tensor = torch.tensor
  monkeypatch.setattr(torch, "tensor",
                      lambda *a, **kw: made.append(a) or tensor(*a, **kw))
  for _ in range(2):
    _, state = tx.apply_(params, grads, state)
  assert not made, made


def test_make_rejects_what_is_not_ported():
  params = {"a/kernel": torch.zeros(2, 2), "b/bias": torch.zeros(3)}
  sched_kw = dict(total_steps=10)
  with pytest.raises(ValueError, match="adamw"):
    t_optim.make(dict(CONFIG, optax_name="adamw"), params,
                 sched_kw=sched_kw)
  with pytest.raises(ValueError):
    t_optim.make(dict(CONFIG, schedule=[("b/.*", {})]), params,
                 sched_kw=sched_kw)
  # Per-example clipping needs a batch axis shared by every gradient.
  tx, _ = t_optim.make(dict(CONFIG, grad_clip_per_example=True,
                            schedule={}), params, sched_kw=sched_kw)
  with pytest.raises(ValueError, match="batch dimension"):
    tx.update({n: torch.ones_like(p) for n, p in params.items()},
              tx.init(params), params)


@pytest.mark.parametrize("kw", [
    dict(decay_type="cosine", warmup_steps=100),
    dict(decay_type="linear", warmup_percent=0.1, linear_end=0.01),
    dict(decay_type="rsqrt", timescale=200, warmup_steps=50, cooldown_steps=80),
    dict(decay_type="stair", steps=[300, 600], mults=[0.1, 0.01]),
    dict(decay_type="polynomial", power=2, warmup_epochs=1,
         scale_with_batchsize=True),
])
def test_schedules_match_jax(kw):
  common = dict(total_steps=1000, batch_size=64, data_size=6400, base=0.3)
  want = j_schedules.create_learning_rate_schedule(**common, **kw)
  got = t_schedules.create_learning_rate_schedule(**common, **kw)
  for step in (0, 1, 49, 50, 99, 100, 101, 299, 300, 500, 901, 999, 1000):
    np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                               rtol=1e-6, atol=1e-9)
  for prefix in ("warmup", "cooldown", "timescale"):
    assert (t_schedules.steps(prefix, kw, 6400, 64, 1000, default=None)
            == j_schedules.steps(prefix, kw, 6400, 64, 1000, default=None))


def test_losses_match_jax():
  rs = np.random.RandomState(1)
  logits = rs.randn(6, 11).astype(np.float32) * 3
  labels = rs.randint(0, 11, size=6)
  soft = np.abs(rs.randn(6, 11)).astype(np.float32)
  soft /= soft.sum(-1, keepdims=True)
  hot = t_losses.onehot(torch.from_numpy(labels), 11, on_value=0.9,
                        off_value=0.01)
  _close(hot, j_losses.onehot(jnp.asarray(labels), 11, on_value=0.9,
                              off_value=0.01), 0)
  tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
  for y in (hot.numpy(), soft):
    for red in (True, False):
      _close(t_losses.softmax_xent(logits=tl, labels=torch.from_numpy(y),
                                   reduction=red),
             j_losses.softmax_xent(logits=jl, labels=jnp.asarray(y),
                                   reduction=red), 1e-6)
      _close(t_losses.sigmoid_xent(logits=tl, labels=torch.from_numpy(y),
                                   reduction=red),
             j_losses.sigmoid_xent(logits=jl, labels=jnp.asarray(y),
                                   reduction=red), 1e-6)
    _close(t_losses.softmax_xent(logits=tl, labels=torch.from_numpy(y),
                                 kl=True),
           j_losses.softmax_xent(logits=jl, labels=jnp.asarray(y), kl=True),
           1e-5)


def test_mask_trees_match_jax():
  names = list(SHAPES)
  patterns = [".*/kernel$", "head/.*", ".*"]
  want = j_trees.make_mask_trees(j_trees.tree_unflatten(
      (n, 0) for n in names), patterns)
  got = t_trees.make_mask_trees(dict.fromkeys(names), patterns)
  for w, g in zip(want, got):
    assert dict(j_trees.tree_flatten_with_names(w)[0]) == g
  got = t_trees.tree_map_with_regex(lambda x, a: x * a,
                                    dict.fromkeys(names, 2),
                                    [("head/.*", 5), (".*bias", 3)])
  assert got["head/bias"] == 10 and got["embedding/bias"] == 6
  assert got["embedding/kernel"] == 2
  with pytest.raises(ValueError):
    t_trees.make_mask_trees({}, ["/a"])


# Kernels of two axes of at least 32 (Adafactor's default
# min_dim_size_to_factor), one of them a DenseGeneral [D, H, hd] kernel.
BIG = {"embedding/kernel": (4, 4, 3, 8), "embedding/bias": (8,),
       "Transformer/encoderblock_0/MlpBlock_0/Dense_0/kernel": (32, 48),
       "Transformer/encoderblock_0/MlpBlock_0/Dense_0/bias": (48,),
       "Transformer/encoderblock_0/Attn/query/kernel": (40, 2, 32),
       "Transformer/encoder_norm/scale": (40,),
       "head/kernel": (48, 5), "head/bias": (5,)}
STATES = {"big_vision.momentum_hp": {optax.TraceState: ("trace",)},
          "big_vision.scale_by_adafactor": {
              optax.FactoredState: ("v_row", "v_col", "v"),
              optax.EmaState: ("ema",)},
          "big_vision.sgd": {}}


def _port_layout(name, x):
  """A JAX-layout array as the port stores it: a kernel [out, in]."""
  if not name.endswith("/kernel"):
    return x
  if name.startswith("embedding"):  # [p, p, c, width]
    return x.reshape(-1, x.shape[-1]).T
  return x.reshape(x.shape[0], -1).T  # [in, out] or [D, H, hd]


def _steps(config, shapes, port_layout=False):
  """5 steps of both optimizers; (JAX params, JAX state, port params in
  the JAX layout, port state)."""
  rs = np.random.RandomState(0)
  params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
  grads = [{n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
           for _ in range(5)]
  sched_kw = dict(total_steps=10, batch_size=8, data_size=100)
  jparams = j_trees.tree_unflatten(params.items())
  tx, _ = j_optim.make(config, jparams, sched_kw=sched_kw)
  jstate = tx.init(jparams)
  lay = _port_layout if port_layout else (lambda n, x: x)
  tparams = {n: torch.from_numpy(np.ascontiguousarray(lay(n, x)))
             for n, x in params.items()}
  ttx, _ = t_optim.make(config, tparams, sched_kw=sched_kw,
                        jax_shapes=shapes if port_layout else None)
  tstate = ttx.init(tparams)
  for g in grads:
    updates, jstate = tx.update(j_trees.tree_unflatten(g.items()), jstate,
                                jparams)
    jparams = optax.apply_updates(jparams, updates)
    _, tstate = ttx.apply_(tparams, {n: torch.from_numpy(
        np.ascontiguousarray(lay(n, x))) for n, x in g.items()}, tstate)
  back = {n: t.numpy() for n, t in tparams.items()}
  if port_layout:  # the port's [out, in] kernels back to the JAX layout
    back = {n: x.T.reshape(shapes[n]) if n.endswith("/kernel") else x
            for n, x in back.items()}
  return jparams, jstate, back, tstate


def _bf16_ulp_close(got, want):
  """Within one bf16 ulp of the JAX value."""
  want = np.asarray(want, np.float32)
  ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
  assert np.all(np.abs(got.float().numpy() - want) <= ulp)


@pytest.mark.parametrize("name,kw,port_layout", [
    ("big_vision.momentum_hp", {}, False),
    ("big_vision.momentum_hp", {"nesterov": True}, False),
    ("big_vision.scale_by_adafactor", {}, False),
    ("big_vision.scale_by_adafactor", {"beta2_cap": 0.95}, False),
    ("big_vision.scale_by_adafactor",
     {"clipping_threshold": 1.0, "dtype_momentum": "float32"}, False),
    ("big_vision.scale_by_adafactor", {}, True),
    ("big_vision.sgd", {}, False),
])
def test_other_rules_match_optax(name, kw, port_layout):
  config = dict(CONFIG, optax_name=name, optax=kw)
  jparams, jstate, tparams, tstate = _steps(config, BIG, port_layout)
  want = dict(j_trees.tree_flatten_with_names(jparams)[0])
  for n in BIG:
    _close(torch.from_numpy(tparams[n]), want[n], 1e-6)
  assert t_optim.get_count(tstate) == j_optim.get_count(jstate) == 5
  live = sorted(n for n in BIG if not n.startswith("embedding/"))
  for cls, keys in STATES[name].items():
    (jaxs,) = j_optim.find_states(jstate, cls)
    for key in keys:
      jleaves = dict(j_trees.tree_flatten_with_names(getattr(jaxs, key))[0])
      for n in live:
        if n not in tstate[key]:  # optax's placeholder of shape (1,)
          assert jleaves[n].shape == (1,), (key, n)
          continue
        got = tstate[key][n]
        if port_layout and key in ("ema", "trace"):
          got = torch.from_numpy(np.ascontiguousarray(
              got.float().numpy().T.reshape(BIG[n]))).to(got.dtype) \
              if n.endswith("/kernel") else got
        if got.dtype == torch.bfloat16:
          _bf16_ulp_close(got, jleaves[n])
        else:
          _close(got, jleaves[n], 1e-6)
  if name == "big_vision.scale_by_adafactor":  # both kinds were taken
    assert tstate["v_row"] and tstate["v"]
    want_dtype = getattr(torch, kw.get("dtype_momentum", "bfloat16"))
    assert tstate["ema"][live[0]].dtype == want_dtype
  if name == "big_vision.momentum_hp":
    assert all(t.dtype == torch.bfloat16 for t in tstate["trace"].values())


def test_per_example_clip_matches_optax():
  """Every gradient has the same leading axis (4 examples); the clipped
  mean then broadcasts over each param's leading axis, in both."""
  shapes = {"a/kernel": (4, 3), "b/kernel": (4, 2, 5), "c/bias": (4,),
            "d/bias": (4, 6)}
  config = dict(CONFIG, optax_name="scale_by_adam", optax={},
                grad_clip_per_example=True, grad_clip_norm=1.5,
                lr_mults=[("a/.*", 2.0)],
                schedule=[("d/.*", None), (".*", dict(warmup_steps=1))])
  jparams, _, tparams, _ = _steps(config, shapes)
  want = dict(j_trees.tree_flatten_with_names(jparams)[0])
  for n in shapes:
    _close(torch.from_numpy(tparams[n]), want[n], 1e-6)
