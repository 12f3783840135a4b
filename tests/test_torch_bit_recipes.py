"""The JAX update of bit_i1k, and CKA.

(The BiT configs' `runlocal` steps on the CPU are in test_torch_bit_train.py
and test_torch_bit_distill.py; every BiT config's diff against its JAX
config, each within its `CUTS`, is in test_torch_configs.py.)

Parity: one step of bit_i1k:runlocal (R26x0.5 at 224 px, batch 32,
momentum_hp with its bf16 trace, gradient clip 1.0) against the JAX
update built as the JAX train.py builds it (`bit.Model`, `optim.make`,
`softmax_xent`), from the same params (the port's init, with the GN params
and the head drawn so that every branch is live) and the same batch of the
port's input pipeline. The config's 1000 warmup steps give the first step
lr 0 on both sides, so the twin runs without its warmup. The loss and the
updated params agree within 1e-5 relative.

CKA: `hsic1` equals the JAX function's within 1e-6 on the same Gram
matrices, and the evaluator's value equals the JAX evaluator's within
1e-6 on the same features (both eval pipelines replaced by the same
batches); both refuse a batch with padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs import bit_i1k
from big_vision_torch.evaluators import common as t_common
from big_vision_torch.evaluators.proj.distill import cka as t_cka
from big_vision_torch.models import convnets as t_cn
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees as t_trees
from big_vision_tpu import optim as j_optim
from big_vision_tpu.evaluators import common as j_common
from big_vision_tpu.evaluators.proj.distill import cka as j_cka
from big_vision_tpu.models import bit as j_bit
from big_vision_tpu.utils import losses as j_losses

def _draw_gn_and_head(model, seed):
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for name, p in model.named_parameters():
      if isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                    t_cn.GroupNorm):
        p.add_(0.3 * torch.randn(p.shape, generator=gen))
    model.head.weight.normal_(0.0, 0.05, generator=gen)


def test_one_step_matches_the_jax_update():
  config = bit_i1k.get_config("runlocal")
  config["schedule"] = dict(config["schedule"], warmup_steps=0)
  trainer = t_train.Trainer(config, device="cpu")
  _draw_gn_and_head(trainer.model, 3)
  # A copy: `convert.params` gives views of CPU params where it can.
  params = jax.tree.map(np.array, convert.params(trainer.model))
  jmodel = j_bit.Model(num_classes=config["num_classes"], **config["model"])
  tx, _ = j_optim.make(config, params, sched_kw=dict(
      total_steps=trainer.total_steps, batch_size=trainer.batch_size,
      data_size=config["input"]["data"]["n"]))

  @jax.jit
  def update(params, opt, images, labels):
    def loss_fn(p):
      logits, _ = jmodel.apply({"params": p}, images, train=True)
      return j_losses.softmax_xent(logits=logits, labels=labels)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates), loss

  it = trainer.input_iter()
  try:
    batch = next(it)
  finally:
    it.close()
  got = trainer.update(batch)["training_loss"].item()
  want_params, want = jax.device_get(update(
      params, tx.init(params), jnp.asarray(batch["image"]),
      jnp.asarray(batch["labels"])))
  np.testing.assert_allclose(got, float(want), rtol=1e-5)
  got_params = t_trees.flatten(convert.params(trainer.model))
  start = t_trees.flatten(params)
  moved = 0.0
  for name, x in t_trees.flatten(want_params).items():
    err = np.abs(got_params[name] - x).max() / np.abs(x).max()
    assert err <= 1e-5, (name, err)
    moved = max(moved, np.abs(x - start[name]).max())
  assert moved > 0


def test_hsic1_matches_jax():
  rng = np.random.RandomState(0)
  x, y = rng.randn(16, 7), rng.randn(16, 5)
  k, l = (a @ a.T for a in (x.astype(np.float32), y.astype(np.float32)))
  got = t_cka.hsic1(torch.from_numpy(k), torch.from_numpy(l)).item()
  want = float(j_cka.hsic1(jnp.asarray(k), jnp.asarray(l)))
  assert abs(got - want) <= 1e-6 * abs(want), (got, want)


def _cka_batches(n_batches, b, pad_last):
  rng = np.random.RandomState(1)
  out = []
  for i in range(n_batches):
    feats = rng.randn(b, 12).astype(np.float32)
    mask = np.ones(b, np.int32)
    if pad_last and i == n_batches - 1:
      mask[-2:] = 0
    out.append({"image": feats, "_mask": mask})
  return out


def _fwd(train_state, batch):
  # The student's features are the first 8 columns, the teacher's a
  # nonlinear mix of all 12.
  del train_state
  x = batch["image"]
  return ((None, {"pre_logits": x[:, :8]}),
          (None, {"pre_logits": (x * x)[:, 2:] + x[:, :10]}))


WHAT = ("pre_logits", "pre_logits")


def _feed(monkeypatch, batches):
  """Both packages' eval pipelines replaced by `batches`."""
  monkeypatch.setattr(t_common, "eval_input_pipeline", lambda **kw: (
      lambda: iter([{k: torch.from_numpy(v) for k, v in b.items()}
                    for b in batches]), len(batches)))
  monkeypatch.setattr(j_common, "eval_input_pipeline", lambda **kw: (
      lambda: iter([{k: jnp.asarray(v) for k, v in b.items()}
                    for b in batches]), len(batches)))


def test_cka_evaluator_matches_jax(monkeypatch):
  _feed(monkeypatch, _cka_batches(3, 8, pad_last=False))
  got = dict(t_cka.Evaluator(_fwd, what=WHAT).run(None))
  want = dict(j_cka.Evaluator(_fwd, what=WHAT).run(None))
  assert abs(got["cka"] - want["cka"]) <= 1e-6 * abs(want["cka"]), (
      got, want)
  assert 0 < got["cka"] < 1


@pytest.mark.parametrize("evaluator", [t_cka.Evaluator, j_cka.Evaluator])
def test_cka_refuses_a_padded_batch(monkeypatch, evaluator):
  _feed(monkeypatch, _cka_batches(2, 8, pad_last=True))
  with pytest.raises(ValueError, match="padding"):
    list(evaluator(_fwd, what=WHAT).run(None))
