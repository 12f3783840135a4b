"""The port's CLIPPO (one tower, `render_unifont`, the SigLIP trainer on
`proj.clippo.one_tower`) against the JAX package's, on the CPU.

* `one_tower` (a ViT-mu/16 with MAP pooling, out_dim 16, at 32px) from one
  JAX init carried across by `utils/convert`: zimg, ztxt and t within
  1e-5, the SigLIP loss's gradients within 1e-5 of max(1, each leaf's
  largest magnitude; up to 16 here); `one_tower.load` of one file
  (`:img`, `:t`) equal to JAX's.
* `render_unifont` pixel for pixel on both paths: PIL's default font (the
  same Pillow serves both packages here) and a Unifont `.hex` written by
  the test (8x16 and 16x16 glyphs, a missing glyph, proportional and
  monospace, rows that wrap and overflow).
* The SigLIP trainer with CLIPPO's one tower against the JAX SigLIP
  trainer: train_clippo's runlocal config cut to ViT-mu/16 at 32px, the
  captions "photo number {label}" rendered from the synthetic labels (the
  JAX synthetic source has no captions), the rsqrt schedule with 1 warmup
  and 1 cooldown step, 3 steps from one init: the loss
  and t within 1e-5 relative a step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch import train as t_train
from big_vision_torch.configs.proj.clippo import train_clippo as t_cfg
from big_vision_torch.models.proj.clippo import one_tower as t_ot
from big_vision_torch.parallel import contrastive as t_con
from big_vision_torch.pp.proj.clippo import pp_ops as t_pp  # noqa: F401
from big_vision_torch.registry import Registry as TRegistry
from big_vision_torch.trainers.proj.image_text import siglip as t_siglip
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_tpu.configs.proj.clippo import train_clippo as j_cfg
from big_vision_tpu.models.proj.clippo import one_tower as j_ot
from big_vision_tpu.ops import attention as j_attention
from big_vision_tpu.parallel import contrastive as j_con
from big_vision_tpu.pp.proj.clippo import pp_ops as j_pp  # noqa: F401
from big_vision_tpu.registry import Registry as JRegistry
from big_vision_tpu.trainers.proj.image_text import siglip as j_siglip

CFG = dict(image=dict(variant="mu/16", pool_type="map"), out_dim=16,
           temperature_init=10.0)


@pytest.fixture(autouse=True)
def _jax_plain_attention(monkeypatch):
  """The JAX ViT's attention through its plain (XLA) reference: on the CPU
  its Pallas kernel would run in interpret mode, to the same function at
  many times the compile time."""
  monkeypatch.setattr(j_attention, "_kernel_ok", lambda *a, **kw: False)


def _port(seed=0, **kw):
  """A port one tower drawn from `seed`, its head N(0, 0.02^2) (the seed's
  zero head would embed every input at 0)."""
  port = t_ot.Model(**{**CFG, **kw}, image_size=32, device="cpu")
  port.initialize(torch.Generator().manual_seed(seed))
  with torch.no_grad():
    port.img.head.weight.normal_(0.0, 0.02,
                                 generator=torch.Generator().manual_seed(9))
  return port


def _images(seed, b=4):
  return np.random.RandomState(seed).uniform(-1, 1, (b, 32, 32, 3)).astype(
      np.float32)


def test_one_tower_and_its_gradients_match_jax():
  port = _port()
  params = convert.params(port)
  model = j_ot.Model(**CFG)
  img, txt = _images(0), _images(1)
  zimg, ztxt, out = model.apply({"params": params}, img, txt)
  got = port(torch.from_numpy(img), torch.from_numpy(txt))
  for g, w in ((got[0], zimg), (got[1], ztxt), (got[2]["t"], out["t"])):
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                               atol=1e-5)

  def loss(p):
    zi, zt, o = model.apply({"params": p}, img, txt)
    return j_con.global_siglip_loss(zi, zt, o["t"][0], 0.0)

  want = convert.state(port, jax.jit(jax.grad(loss))(params))
  port.zero_grad()
  zi, zt, o = port(torch.from_numpy(img), torch.from_numpy(txt))
  t_con.global_siglip_loss(zi, zt, o["t"][0], torch.zeros(())).backward()
  got = dict(port.named_parameters())
  assert sorted(want) == sorted(got)
  for name, g in want.items():  # 1e-5 of max(1, the leaf's largest)
    g = np.asarray(g)
    err = np.abs(got[name].grad.numpy() - g).max()
    assert err <= 1e-5 * max(1.0, np.abs(g).max()), (name, err)


def test_one_tower_load_matches_jax(tmp_path):
  src = _port(seed=1)
  path = str(tmp_path / "clippo.npz")
  checkpoints.npz_save(convert.params(src), path)
  init = convert.params(_port(seed=2))
  want = j_ot.load(init, path, CFG)
  got = t_ot.load(init, path, CFG)
  flat = lambda t: {k: np.asarray(v) for k, v in
                    convert.trees.flatten(t).items()}
  want, got = flat(want), flat(got)
  assert sorted(want) == sorted(got)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  port = _port(seed=2)
  t_train.load_into(port, t_ot, path, CFG)
  for name, p in port.named_parameters():
    assert torch.equal(p, dict(src.named_parameters())[name]), name


def _both(spec):
  return (TRegistry.lookup(f"preprocess_ops.{spec}")(),
          JRegistry.lookup(f"preprocess_ops.{spec}")())


TEXTS = ["a striped cat on a street.", "",
         "A Very Long Caption " * 12, ["first of two", "second"],
         b"bytes caption", "Ünïcödé and 漢字 glyphs"]


@pytest.mark.parametrize("spec", [
    "render_unifont(64)", "render_unifont(32, lower=False, outkey='labels')",
    "render_unifont(48, max_chars=20, background_brightness=255, "
    "text_brightness=10)"])
def test_render_unifont_pil_equals_jax_pixel_for_pixel(spec):
  t_op, j_op = _both(spec)
  out = "labels" if "outkey" in spec else "image"
  for text in TEXTS:
    got = t_op.run_host({"texts": text}, None)[out]
    want = j_op.run_host({"texts": text}, None)[out]
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _hex_file(path):
  """A small Unifont table: 8x16 glyphs for 'a'-'e' and ' ', 16x16 glyphs
  for two CJK code points; 'z' is missing."""
  rs = np.random.RandomState(3)
  lines = []
  for ch in "abcde ":
    rows = rs.randint(0, 256, 16, dtype=np.uint8)
    rows &= 0x7E if ch != " " else 0  # blank edge columns
    lines.append(f"{ord(ch):04X}:{bytes(rows).hex().upper()}")
  for code in (0x6F22, 0x5B57):
    lines.append(f"{code:04X}:{rs.randint(0, 256, 32, dtype=np.uint8).tobytes().hex().upper()}")
  path.write_text("\n".join(lines) + "\n")
  return str(path)


@pytest.mark.parametrize("kw", ["", ", monospace=True",
                                ", spacing=3, min_width=6"])
def test_render_unifont_hex_equals_jax_pixel_for_pixel(tmp_path, kw):
  path = _hex_file(tmp_path / "unifont.hex")
  t_op, j_op = _both(f"render_unifont(40, unifont_path={path!r}{kw})")
  for text in ("abc", "ab cd ea", "abz" * 9, "漢字a字漢" * 6, "e" * 200,
               ["dab", "x"]):
    got = t_op.run_host({"texts": text}, None)["image"]
    want = j_op.run_host({"texts": text}, None)["image"]
    assert got.shape == (40, 40, 3)
    np.testing.assert_array_equal(got, want)
  assert (got != 127).any()


def _rows(workdir):
  with open(workdir / "big_vision_metrics.txt") as f:
    return [r for r in map(json.loads, f) if "training_loss" in r]


def test_siglip_trainer_on_one_tower_tracks_the_jax_trainer(tmp_path):
  init = tmp_path / "init.npz"
  checkpoints.npz_save(convert.params(_port()), str(init))
  arg = "runlocal,res=32,variant=mu/16"
  overrides = dict(
      model_init=str(init), log_training_steps=1, ckpt_steps=None, evals={},
      total_steps=3, schedule=dict(decay_type="rsqrt", timescale=5_000,
                                   warmup_steps=1, cooldown_steps=1))
  data = dict(name="synthetic", n=64, num_classes=8, h=40, w=40)
  pp = ("decode|resize(32)|value_range(-1, 1)"
        "|strfmt('photo number {label}', outkey='texts')"
        "|render_unifont(32, outkey='labels')"
        "|value_range(-1, 1, inkey='labels', outkey='labels')"
        "|keep('image', 'labels')")
  jax_config = j_cfg.get_config(arg)
  jax_config.update(overrides)
  jax_config.evals = {}  # `update` merges nested ConfigDicts
  jax_config.model.out_dim = 16
  jax_config.input.data = data
  jax_config.input.pp = pp
  j_siglip.main(config=jax_config, workdir=str(tmp_path / "jax"))
  config = t_cfg.get_config(arg)
  config.update(overrides)
  config["model"]["out_dim"] = 16
  config["input"].update(data=data, pp=pp)
  trainer = t_train.train(config, str(tmp_path / "port"), device="cpu",
                          trainer_cls=t_siglip.Trainer)
  assert isinstance(trainer.model, t_ot.Model)
  want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
  assert [r["step"] for r in want] == [r["step"] for r in got] == [1, 2, 3]
  for w, g in zip(want, got):
    for k in ("training_loss", "t"):
      assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (k, w, g)
  assert got[0]["l2_grads"] > 0
