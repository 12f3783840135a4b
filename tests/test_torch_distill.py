"""Port's FlexiViT distillation vs the JAX one: distances, updates, resume.

`dist` of every kind is held against the JAX package's on the same logits.
The update parity runs the `runlocal` version of
configs/proj/flexivit/i21k_distill.py (ViT-mu student, mu/8 teacher at
240px, batch 8) in f32 with an f32 first moment, as
tests/test_torch_flexi_train.py does. Both start from the JAX inits with
seeded nonzero heads (a zero head makes the soft targets uniform) and 100
classes instead of 21843: the KL distance is a difference of two sums
over the classes, each about 30 times the distance at 21843 classes,
where the two packages' f32 sums, taken in other orders, alone differ by
about 1e-5 of the loss. The
port's teacher is loaded from an `.npz` through `prof_init`, as the chip
run loads its ViT-B/8. The JAX side is built in the test as the JAX
distill trainer's `update_fn` computes: the student at the step's seqhw,
the teacher in eval mode, the mean KL distance, its gradients, `optim.make`'s
optimizer and `l2_grads`. The teacher's T = 901 takes the port's blocked
path ("auto"; its plain version on the CPU) and the JAX package's XLA path
(its "auto" gives XLA at this size; named explicitly here): in f32 both
compute the same function up to the order of sums. Loss and `l2_grads`
agree within 1e-5 relative per step; the total update within 1e-4 of its
l2 norm.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from big_vision_torch import input_pipeline
from big_vision_torch.configs.proj.flexivit import i21k_distill
from big_vision_torch.evaluators.proj.distill import distance as t_dist
from big_vision_torch.trainers.proj.flexi import distill as t_distill
from big_vision_torch.utils import checkpoints as t_ckpt
from big_vision_torch.utils import convert
from big_vision_torch.utils import schedules as t_sched
from big_vision_tpu import optim as j_optim
from big_vision_tpu.evaluators.proj.distill import distance as j_dist
from big_vision_tpu.models import vit as j_vit
from big_vision_tpu.models.proj.flexi import vit as j_flexi
from big_vision_tpu.utils import checkpoints as j_ckpt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPEC = "big_vision_torch/configs/proj/flexivit/i21k_distill.py:runlocal"


@pytest.mark.parametrize("kind,kw", [
    ("euclidean", {}), ("l2", {}), ("hard", {}), ("hard", dict(ls=0.1)),
    ("kl", {}), ("kl", dict(t=2.0)), ("logsoftmax_euclidean", {}),
    ("agree", {}), ("agree", dict(k=3)),
])
def test_dist_matches_jax(kind, kw):
  rs = np.random.RandomState(0)
  s, t = (rs.randn(6, 11).astype(np.float32) * 3 for _ in range(2))
  got = t_dist.get_dist_fn(kind=kind, **kw)(torch.from_numpy(s),
                                            torch.from_numpy(t))
  want = j_dist.dist(jnp.asarray(s), jnp.asarray(t), kind, **kw)
  assert got.shape == (6,)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)
  with pytest.raises(ValueError, match="Unknown distance"):
    t_dist.dist(torch.from_numpy(s), torch.from_numpy(t), "cosine")


def _init_with_head(model, res, seed):
  params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, res, res, 3)))
  params = jax.device_get(params["params"])
  params["head"]["kernel"] = 0.1 * np.random.RandomState(seed).randn(
      *params["head"]["kernel"].shape).astype(np.float32)
  return params


def _config(arg):
  """The runlocal config with `arg` and 100 classes (see the docstring)."""
  config = i21k_distill.get_config(f"runlocal,{arg}")
  config["num_classes"] = 100
  config["input"]["data"]["num_classes"] = 100
  config["input"]["pp"] = config["input"]["pp"].replace("onehot(21843",
                                                        "onehot(100")
  return config


def test_three_updates_match_the_jax_update(tmp_path):
  base = _config("")
  kw = lambda name: {k: v for k, v in base[name].items() if k != "attn_impl"}
  jteacher = j_vit.Model(base["num_classes"], attn_impl="xla", **kw("prof"))
  jstudent = j_flexi.Model(base["num_classes"], **kw("student"))
  teacher = _init_with_head(jteacher, 240, 1)
  params = _init_with_head(jstudent, 240, 0)
  j_ckpt.npz_save(teacher, str(tmp_path / "prof.npz"))
  config = _config(f"prof_init={tmp_path}/prof.npz")
  config["optax"] = {}  # an f32 first moment: see the module docstring
  trainer = t_distill.Trainer(config, device="cpu")
  start = convert.vit(params)
  trainer.model.load_state_dict(
      {k: torch.from_numpy(np.array(v)) for k, v in start.items()})
  tx, _ = j_optim.make(config, params, sched_kw=dict(
      total_steps=trainer.total_steps, batch_size=trainer.batch_size,
      data_size=config["input"]["data"]["n"]))
  opt = tx.init(params)

  @jax.jit
  def teacher_logits(images):
    return jteacher.apply({"params": teacher}, images, train=False)[0]

  def update(params, opt, images, t_logits, seqhw):
    def loss_fn(p):
      logits, _ = jstudent.apply({"params": p}, images, train=True,
                                 seqhw=seqhw)
      return jnp.mean(j_dist.dist(logits, t_logits, "kl", t=1.0))
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt = tx.update(grads, opt, params)
    l2 = jnp.sqrt(sum(jnp.vdot(g, g) for g in jax.tree.leaves(grads)))
    return optax.apply_updates(params, updates), opt, loss, l2
  update = jax.jit(update, static_argnums=4)

  it = trainer.input_iter()
  try:
    for step in range(1, 4):
      batch = next(it)
      kw = trainer.step_kwargs(step)
      got = trainer.update(batch, **kw)
      images = jnp.asarray(batch["image"].numpy())
      params, opt, loss, l2 = update(params, opt, images,
                                     teacher_logits(images), kw["seqhw"])
      assert got["distill_loss"].item() > 0.1
      np.testing.assert_allclose(got["training_loss"].item(), float(loss),
                                 rtol=1e-5)
      np.testing.assert_allclose(got["l2_grads"].item(), float(l2),
                                 rtol=1e-5)
      assert {"task_loss_student", "task_loss_prof",
              "distill_loss_prof"} <= set(got)
  finally:
    it.close()
  want = convert.vit(jax.device_get(params))
  diff = moved = 0.0
  for name, p in trainer.model.named_parameters():
    if name.endswith("attn.key.bias"):  # rounding noise, scaled up by Adam
      continue
    diff += np.sum((p.detach().numpy() - want[name]) ** 2)
    moved += np.sum((want[name] - start[name]) ** 2)
  assert moved > 0 and (diff / moved) ** 0.5 <= 1e-4, (diff / moved) ** 0.5
  for name, p in trainer.teachers["prof"].named_parameters():  # frozen
    np.testing.assert_array_equal(p.numpy(), convert.vit(teacher)[name])


def test_mixup_mixes_what_every_model_sees():
  config = _config("")
  config["mixup"] = dict(p=0.2, fold_in=None)
  trainer = t_distill.Trainer(config, device="cpu")
  with torch.no_grad():  # nonzero soft targets
    trainer.teachers["prof"].head.weight.normal_(
        generator=torch.Generator().manual_seed(0))
  it = trainer.input_iter()
  batch = next(it)
  it.close()
  _, _, mixed = trainer.loss_and_grads(batch, seqhw=15)
  a = t_sched.get_mixup(input_pipeline.step_generator(trainer.seed + 2, 0,
                                                      "cpu"), 0.2).args[0]
  (image, labels), _ = t_sched.mix(a, batch["image"], batch["labels"])
  trainer.config["mixup"] = None
  _, _, want = trainer.loss_and_grads({"image": image, "labels": labels},
                                      seqhw=15)
  assert mixed["distill_loss"].item() > 0.01
  for name in ("distill_loss", "task_loss_student", "task_loss_prof"):
    assert torch.equal(mixed[name], want[name]), name


def test_training_from_step_continues_the_stream():
  cfg = i21k_distill.get_config("runlocal")["input"]
  it, _ = input_pipeline.training(cfg, device="cpu")
  full = [next(it) for _ in range(5)]
  it.close()
  it = input_pipeline.training_from_step(cfg, 3, device="cpu")
  resumed = [next(it) for _ in range(2)]
  it.close()
  for want, got in zip(full[3:], resumed):
    for key in want:
      assert torch.equal(want[key], got[key]), key
  assert not torch.equal(full[0]["image"], resumed[0]["image"])


def _rows(workdir):
  return [json.loads(line) for line in
          (workdir / "big_vision_metrics.txt").read_text().splitlines()]


def test_command_line_checkpoints_and_resumes(tmp_path):
  # A teacher with a seeded nonzero head, written as the port writes one.
  teacher = t_distill.vit.Model(21843, variant="mu/8", pool_type="tok",
                                image_size=240, device="cpu")
  teacher.initialize(torch.Generator().manual_seed(3))
  with torch.no_grad():
    teacher.head.weight.normal_(generator=torch.Generator().manual_seed(4))
  t_ckpt.npz_save(convert.vit_params(teacher), str(tmp_path / "prof.npz"))
  spec = f"{SPEC},ckpt=1,prof_init={tmp_path}/prof.npz"
  args = ["--device", "cpu", "--config"]
  whole = t_distill.main(args + [spec, "--workdir", str(tmp_path / "whole")])
  first = t_distill.main(args + [f"{spec},stop=2", "--workdir",
                                 str(tmp_path / "cut")])
  assert first.first_step == 0 and isinstance(first, t_distill.Trainer)
  prefix = str(tmp_path / "cut" / "ckpt.bv")
  assert t_ckpt.last_checkpoint_dir(prefix).endswith("ckpt.bv-000000002-tmp")
  resumed = t_distill.main(args + [spec, "--workdir", str(tmp_path / "cut")])
  assert resumed.first_step == 2
  assert t_ckpt.last_checkpoint_dir(prefix).endswith("ckpt.bv-000000003-tmp")
  want, got = _rows(tmp_path / "whole"), _rows(tmp_path / "cut")
  assert [r["step"] for r in got[1:]] == [1, 2, 0, 3]
  for w, g in zip(want[1:], got[1:3] + got[4:]):
    assert w["step"] == g["step"] and g["distill_loss"] > 0.1
    assert w["training_loss"] == g["training_loss"], (w, g)
    assert w["l2_grads"] == g["l2_grads"], (w, g)
  for name, p in whole.params.items():
    assert torch.equal(p, resumed.params[name]), name


def test_refuses_to_start_without_a_card(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("this machine has a CUDA device")
  with pytest.raises(RuntimeError, match="--device cpu"):
    t_distill.main(["--config", SPEC, "--workdir", str(tmp_path)])


@pytest.mark.parametrize("key,value", [
    ("evals", dict(test={})), ("student_name", "bit"),
    ("prof_name", "proj.uvim.vit"),
])
def test_unported_keys_are_refused(key, value):
  with pytest.raises(ValueError, match=key):
    t_distill.Trainer({**i21k_distill.get_config("runlocal"), key: value},
                      device="cpu")
