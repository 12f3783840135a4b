"""The port's JetFormer, its distributions, patch_pca, samplers and trainer
against the JAX package's, on the CPU.

`right_align`: the valid tokens, their attention among themselves and the
aligned mask equal to JAX's (whose padded rows are unspecified). The GMM
head (`mixture_from_raw` with `square_plus` scales, temperatures), its
log-prob and mean, the categorical's log-prob (-inf out of range), the
per-channel mixture and the lower-triangular Normal against JAX's within
1e-5; the deterministic parts of CFG sampling (the component replayed on
the unconditional mixture, the guided log-density and mean) equal to
JAX's; the CFG sampler's moments (w = 0 is the conditional Normal; w = 1
moves the mean to loc_c + w (loc_c - loc_u)). patch_pca: the flatten
equal to JAX's encode, decode its inverse. The model (random weights
carried by `utils/convert.py`, both orders, label drops, `num_vocab_
repeats`): text and image logits within 1e-5 of the JAX model's, every
gradient within 1e-4 of its max; prefill and extend on the KV cache equal
to teacher forcing, with a padded prompt; the samplers' shapes. Gemma
dropout: its rate and its `dropout_bdims` (one mask shared along them),
the 1/(1 - rate) scale, and `get_drop_labels`' rate. The trainer: a 2-step
twin of configs/proj/jetformer/smoke.py (label drops 0, dropout 0) against
the JAX trainer's `main` from one init, the port's draws of each step
replaced by the JAX trainer's (the RGB curriculum, dequantization, input
noise); every metric within 1e-4 relative. The JAX adaptor's attention
runs on its plain reference (`_kernel_ok` patched to False).
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from big_vision_torch import optim as t_optim
from big_vision_torch import train as t_train
from big_vision_torch.configs.proj.jetformer import smoke as t_smoke
from big_vision_torch.models import common as t_common
from big_vision_torch.models.ppp import gemma as t_gemma
from big_vision_torch.models.proj.givt import distributions as t_dist
from big_vision_torch.models.proj.jetformer import jetformer as t_jf
from big_vision_torch.models.proj.jetformer import patch_pca as t_pca
from big_vision_torch.trainers.proj.jetformer import predict_fns as t_pf
from big_vision_torch.trainers.proj.jetformer import train as t_jf_train
from big_vision_torch.utils import checkpoints
from big_vision_torch.utils import convert
from big_vision_torch.utils import trees
from big_vision_tpu.configs.proj.jetformer import smoke as j_smoke
from big_vision_tpu.models.proj.givt import distributions as j_dist
from big_vision_tpu.models.proj.jetformer import jetformer as j_jf
from big_vision_tpu.models.proj.jetformer import patch_pca as j_pca
from big_vision_tpu.ops import attention as j_attention
from big_vision_tpu.trainers.proj.jetformer import train as j_jf_train

torch.backends.cuda.matmul.allow_tf32 = False
T = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731


@pytest.fixture(autouse=True)
def _plain_jax_attention(monkeypatch):
  monkeypatch.setattr(j_attention, "_kernel_ok", lambda *a, **kw: False)


def test_right_align_equals_jax():
  rs = np.random.RandomState(0)
  x = rs.randn(3, 7, 4).astype(np.float32)
  mask = np.array([[1, 0, 1, 1, 0, 1, 0], [1] * 7, [0, 0, 1, 0, 1, 1, 1]],
                  bool)
  attn = np.tril(np.ones((7, 7), bool))[None] & mask[:, None, :]
  want = j_jf.right_align(jnp.asarray(x), jnp.asarray(attn),
                          jnp.asarray(mask))
  got = t_jf.right_align(T(x), T(attn), T(mask))
  np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
  for i in range(3):
    valid = np.asarray(want[2][i])
    np.testing.assert_array_equal(got[0][i].numpy()[valid],
                                  np.asarray(want[0][i])[valid])
    np.testing.assert_array_equal(got[1][i].numpy()[np.ix_(valid, valid)],
                                  np.asarray(want[1][i])[np.ix_(valid,
                                                                valid)])


def _raw(shape, seed=0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("temps", [(None, None), (0.9, 1.1)])
def test_gmm_head_equals_jax(temps):
  m, d = 3, 5
  logits = _raw((2, 4, m + 2 * m * d))
  x = _raw((2, 4, d), seed=1)
  kw = dict(num_mixtures=m, out_dim=d, scale_tol=1e-6,
            temp_scales=temps[0], temp_probs=temps[1])
  jp = j_dist.mixture_from_raw(jnp.asarray(logits), **kw)
  tp = t_dist.mixture_from_raw(T(logits), **kw)
  for a, b in ((jp.log_prob(jnp.asarray(x)), tp.log_prob(T(x))),
               (jp.mean(), tp.mean()), (jp.scales, tp.scales)):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                               atol=1e-5)
  # The per-channel mixture and the lower-triangular Normal.
  logits_pc = _raw((2, 3 * m * d), seed=2)
  jp = j_dist.per_channel_from_raw(jnp.asarray(logits_pc), num_mixtures=m,
                                   scale_tol=1e-6)
  tp = t_dist.per_channel_from_raw(T(logits_pc), num_mixtures=m,
                                   scale_tol=1e-6)
  np.testing.assert_allclose(tp.log_prob(T(x[:, 0])).numpy(),
                             np.asarray(jp.log_prob(jnp.asarray(x[:, 0]))),
                             rtol=1e-5, atol=1e-5)
  logits_tri = _raw((2, d * d + d), seed=3)
  jp = j_dist.mvn_tri_from_raw(jnp.asarray(logits_tri), out_dim=d,
                               scale_tol=1e-6)
  tp = t_dist.mvn_tri_from_raw(T(logits_tri), out_dim=d, scale_tol=1e-6)
  np.testing.assert_allclose(tp.log_prob(T(x[:, 0])).numpy(),
                             np.asarray(jp.log_prob(jnp.asarray(x[:, 0]))),
                             rtol=1e-5, atol=1e-5)


def test_categorical_equals_jax():
  logits = _raw((3, 5))
  x = np.array([0, 4, 2])
  want = j_dist.Categorical(jnp.asarray(logits)).log_prob(jnp.asarray(x))
  got = t_dist.Categorical(T(logits)).log_prob(T(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
  assert t_dist.Categorical(T(logits)).log_prob(
      torch.tensor([0, 5, 2]))[1].item() == -math.inf


def test_cfg_deterministic_parts_equal_jax():
  m, d = 3, 4
  lc, lu = _raw((2, m + 2 * m * d)), _raw((2, m + 2 * m * d), seed=1)
  kw = dict(num_mixtures=m, out_dim=d, scale_tol=1e-6)
  comp = np.eye(m, dtype=np.float32)[[2, 0]]
  j_c, j_u = (j_dist.mixture_from_raw(jnp.asarray(v), **kw) for v in (lc, lu))
  t_c, t_u = (t_dist.mixture_from_raw(T(v), **kw) for v in (lc, lu))
  for jp, tp in ((j_c, t_c), (j_u, t_u)):
    want = j_dist.select_component(jp, component=jnp.asarray(comp))
    got = t_dist.select_component(tp, component=T(comp))
    for a, b in zip(want[:2], got[:2]):
      np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
  jloc_c, jsc_c, _ = j_dist.select_component(j_c, component=jnp.asarray(comp))
  jloc_u, jsc_u, _ = j_dist.select_component(j_u, component=jnp.asarray(comp))
  jcfg = j_dist.GaussianCFG(jloc_c, jsc_c, jloc_u, jsc_u, 1.5)
  tcfg = t_dist.GaussianCFG(*(T(v) for v in (jloc_c, jsc_c, jloc_u, jsc_u)),
                            1.5)
  x = _raw((2, d), seed=5)
  np.testing.assert_allclose(tcfg.log_prob(T(x)).numpy(),
                             np.asarray(jcfg.log_prob(jnp.asarray(x))),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(tcfg.mean().numpy(), np.asarray(jcfg.mean()),
                             rtol=1e-6)
  # The envelope bounds the guided density: p/q <= its factor everywhere.
  scale_env, log_fac = tcfg.envelope()
  xs = tcfg.loc_c + scale_env * torch.linspace(-9.5, 9.5, 101)[:, None, None]
  q = torch.distributions.Normal(tcfg.loc_c, scale_env)
  ratio = tcfg.log_prob(xs) - q.log_prob(xs)
  assert torch.all(ratio <= log_fac + 1e-4)


def test_cfg_sampler_moments():
  g = torch.Generator().manual_seed(0)
  loc_c, scale_c = torch.tensor([[0.5, -1.0]]), torch.tensor([[0.3, 0.7]])
  cfg = t_dist.GaussianCFG(loc_c, scale_c, loc_c + 1.0, scale_c, w=0.0)
  s = cfg.sample(g, max_samples=128)
  samples = torch.stack([cfg.sample(g) for _ in range(2000)])
  np.testing.assert_allclose(samples.mean(0)[0].numpy(), [0.5, -1.0],
                             atol=0.05)
  np.testing.assert_allclose(samples.std(0)[0].numpy(), [0.3, 0.7],
                             atol=0.05)
  assert s.shape == loc_c.shape
  cfg = t_dist.GaussianCFG(torch.tensor([[1.0]]), torch.tensor([[0.5]]),
                           torch.tensor([[0.0]]), torch.tensor([[0.5]]), w=1.0)
  samples = torch.stack([cfg.sample(g) for _ in range(2000)])
  assert abs(samples.mean().item() - 2.0) < 0.1


def test_patch_pca_equals_jax_and_round_trips():
  kw = dict(input_size=(8, 12), patch_size=(4, 4), codeword_dim=48,
            noise_std=0.0, skip_pca=True)
  x = np.random.RandomState(0).uniform(-0.9, 0.9, (2, 8, 12, 3)).astype(
      np.float32)
  jm = j_pca.Model(**kw)
  (mu, logvar), _ = jm.init_with_output(jax.random.PRNGKey(0),
                                        jnp.asarray(x), method=jm.encode)
  tm = t_pca.Model(**kw)
  tmu, tlogvar = tm.encode(T(x))
  np.testing.assert_array_equal(tmu.numpy(), np.asarray(mu))
  assert torch.all(tlogvar == 0)
  np.testing.assert_array_equal(tm.decode(tmu).numpy(), x)
  np.testing.assert_array_equal(
      tm.decode(tmu).numpy(),
      np.asarray(jm.apply({"params": {}}, mu, method=jm.decode)))
  with pytest.raises(NotImplementedError, match="skip_pca=False"):
    t_pca.Model(**{**kw, "skip_pca": False, "pca_init_file": "pca.npz"})


MODEL = dict(width=32, depth=2, mlp_dim=64, num_heads=2, num_kv_heads=1,
             head_dim=16, vocab_size=11, bos_id=8, boi_id=9, nolabel_id=10,
             out_dim=6, num_mixtures=3, scan=True)


def _random_params(model, *args, seed=0, scale=0.3, **kw):
  shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                             **kw))["params"]
  rs = np.random.RandomState(seed)
  return jax.tree.map(
      lambda s: (rs.randn(*s.shape) * scale).astype(np.float32), shapes)


@pytest.mark.parametrize("repeats", [1, 2])
def test_model_logits_and_gradients_equal_jax(repeats):
  cfg = dict(MODEL, num_vocab_repeats=repeats)
  rs = np.random.RandomState(1)
  text = np.array([[1, 2], [3, 4], [5, 0]], np.int32)
  text_mask = np.array([[1, 1], [1, 1], [1, 0]], bool)
  img = rs.randn(3, 5, 6).astype(np.float32)
  tf = np.array([True, False, True])
  drop = np.array([False, True, True])
  args = (jnp.asarray(text), jnp.asarray(img), jnp.asarray(tf))
  kw = dict(text_input_mask=jnp.asarray(text_mask),
            drop_prefix=jnp.asarray(drop))
  jmodel = j_jf.Model(**cfg)
  params = _random_params(jmodel, *args, **kw)

  def loss(p):
    tl, il, pmf, pdf, _ = jmodel.apply({"params": p}, *args, **kw)
    return (jnp.sum(-pmf.log_prob(args[0])) - jnp.sum(pdf.log_prob(args[1])),
            (tl, il))
  (_, (tl, il)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
      params)

  tmodel = t_jf.Model(**cfg, device="cpu")
  convert.load(tmodel, convert.state(tmodel, params))
  ttl, til, pmf, pdf, _ = tmodel(T(text).long(), T(img), T(tf),
                                 text_input_mask=T(text_mask),
                                 drop_prefix=T(drop))
  np.testing.assert_allclose(ttl.detach().numpy(), np.asarray(tl),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(til.detach().numpy(), np.asarray(il),
                             rtol=1e-5, atol=1e-5)
  ((-pmf.log_prob(T(text).long())).sum() - pdf.log_prob(T(img)).sum()
   ).backward()
  want = convert.state(tmodel, jax.device_get(grads))
  for name, p in tmodel.named_parameters():
    w = want[name]
    assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(),
                                                          1e-6), name
  back = trees.flatten(convert.params(tmodel))
  flat = trees.flatten(params)
  assert sorted(back) == sorted(flat)
  for k, v in flat.items():
    np.testing.assert_allclose(back[k], v, rtol=0, atol=0)


def test_prefill_and_extend_equal_teacher_forcing():
  cfg = dict(MODEL, num_vocab_repeats=1)
  rs = np.random.RandomState(1)
  text = torch.tensor([[1, 2, 3], [4, 5, 0]])
  text_mask = torch.tensor([[1, 1, 1], [1, 1, 0]], dtype=torch.bool)
  img = torch.from_numpy(rs.randn(2, 4, 6).astype(np.float32))
  tf = torch.ones(2, dtype=torch.bool)
  jmodel = j_jf.Model(**cfg)
  params = _random_params(jmodel, jnp.asarray(text.numpy()),
                          jnp.asarray(img.numpy()), jnp.asarray(tf.numpy()),
                          text_input_mask=jnp.asarray(text_mask.numpy()))
  model = t_jf.Model(**cfg, device="cpu")
  convert.load(model, convert.state(model, params))
  with torch.no_grad():
    _, want, *_ = model(text, img, tf, text_input_mask=text_mask)
    jwant = jax.jit(lambda p, *a, **kw: jmodel.apply(p, *a, **kw)[1])(
        {"params": params}, jnp.asarray(text.numpy()),
        jnp.asarray(img.numpy()), jnp.asarray(tf.numpy()),
        text_input_mask=jnp.asarray(text_mask.numpy()))
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-5)
    x, attn, im = model.embed_image_and_text(
        text, img[:, :0], text_first_mask=tf, text_input_mask=text_mask,
        shift=False)
    pre, cache = model.prefill_cache(x, attn, im,
                                     cache_size=x.shape[1] + 3)
    got = [model.img_logits(pre[:, -1:])]
    for i in range(3):
      got.append(model.img_logits(model.extend_cache(
          model.img_emb(img[:, i:i + 1]), cache)))
  np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                             atol=2e-5)


def test_samplers_shapes():
  model = t_jf.Model(**MODEL, device="cpu").initialize(
      torch.Generator().manual_seed(0))
  with torch.no_grad():
    model.img_head.weight.normal_(0, 0.1, generator=torch.Generator())
  g = torch.Generator().manual_seed(2)
  text = torch.tensor([[1, 2], [3, 4]])
  out = t_pf.sample_image_latents({"text": text}, model=model, decode_len=4,
                                  generator=g)
  assert out["out_tokens"].shape == (2, 4, 6)
  assert torch.isfinite(out["out_tokens"]).all()
  out = t_pf.sample_image_latents({"text": text}, model=model, decode_len=3,
                                  cfg_weight=1.5, generator=g)
  assert out["out_tokens"].shape == (2, 3, 6)
  assert torch.isfinite(out["out_tokens"]).all()
  # The codecs: patches, then the adaptor, and back.
  from big_vision_torch.models.proj.jet import jet as t_jet
  pca = t_pca.Model(input_size=(8, 8), patch_size=(4, 4), codeword_dim=48,
                    noise_std=0.0, skip_pca=True)
  adaptor = t_jet.Model(depth=2, ps=1, kinds=("channels",), emb_dim=16,
                        num_heads=2, image_shape=(2, 2, 48), device="cpu")
  adaptor.initialize(g)
  with torch.no_grad():
    fp = adaptor.couplings.layer.dnn.final_proj
    fp.weight.normal_(0, 0.05, generator=g)
    images = torch.rand(2, 8, 8, 3, generator=g) * 1.8 - 0.9
    tokens = t_pf.encode_images(images, adaptor=adaptor, patch_pca=pca)
    back = t_pf.decode_images(tokens, adaptor=adaptor, patch_pca=pca)
  assert tokens.shape == (2, 4, 48) and not torch.allclose(
      tokens, pca.encode(images)[0])
  torch.testing.assert_close(back, images, rtol=0, atol=1e-5)
  out = t_pf.sample_text({"image_latents": torch.randn(2, 4, 6),
                          "text": None}, model=model, decode_len=3,
                         generator=g)
  assert out["out_tokens"].shape == (2, 3)
  assert ((out["out_tokens"] >= 0) & (out["out_tokens"] < 11)).all()


def test_gemma_dropout_rate_and_broadcast_dims():
  g = torch.Generator().manual_seed(0)
  x = torch.ones(64, 32, 48)
  y = t_common.dropout(x, 0.1, g, broadcast_dims=(1,))
  kept = y != 0
  assert torch.all(kept == kept[:, :1, :])  # one mask along dim 1
  assert torch.allclose(y[kept], torch.tensor(1 / 0.9))
  rate = 1 - kept[:, 0, :].float().mean().item()
  assert abs(rate - 0.1) < 0.02, rate
  block = t_gemma.Block(2, 1, 32, 16, 64, "rsqrt_head_dim", None, False,
                        dropout=0.25, dropout_bdims=(-2,), device="cpu")
  for p in block.parameters():
    torch.nn.init.normal_(p, 0, 0.1, generator=g)
  h = torch.randn(4, 6, 32, generator=g)
  pos = torch.arange(6)[None].expand(4, 6)
  mask = torch.tril(torch.ones(4, 1, 6, 6, dtype=torch.bool))
  with torch.no_grad():
    plain = block(h, pos, mask)
    again = block(h, pos, mask, rng=torch.Generator().manual_seed(1))
  assert not torch.equal(plain, again)
  model = t_jf.Model(**{**MODEL, "drop_labels_probability": 0.3},
                     device="cpu")
  drops = model.get_drop_labels(torch.Generator().manual_seed(3), 20000)
  assert abs(drops.float().mean().item() - 0.3) < 0.02
  assert t_jf.Model(**MODEL, device="cpu").get_drop_labels(g, 4) is None


def _jax_draws(config, count, images, out_dim):
  """The JAX JetFormer trainer's draws of the step `count` (its keys)."""
  static = (config.get("seed", 0), images.shape, out_dim,
            config["input_noise_std"], config["text_prefix_prob"],
            tuple(sorted(config["patch_pca"]["model"].items())))
  order, rgb, noisy, std, noise = _jax_draws_jit(count, *static)
  return {"order": T(order), "rgb": T(rgb), "dequant_flat": T(noisy),
          "in_std": T(std), "in_noise": T(noise), "drop": None}


@functools.partial(jax.jit, static_argnums=range(1, 7))
def _jax_draws_jit(count, seed, shape, out_dim, input_noise_std,
                   text_prefix_prob, pca_kw):
  rng = jax.random.PRNGKey(seed)
  rng, _ = jax.random.split(rng)
  _, rng_loop = jax.random.split(rng)
  _, rng_model = jax.random.split(jax.random.fold_in(rng_loop, count))
  keys = jax.random.split(rng_model, 5)
  bs = shape[0]
  rgb = jax.random.normal(keys[3], shape)
  pca = j_pca.Model(**dict(pca_kw))
  noisy, _ = pca.apply({"params": {}}, jnp.zeros(shape), method=pca.encode,
                       rngs={"dropout": keys[4]})
  _, rng_std, rng_in = jax.random.split(keys[0], 3)
  n = noisy.shape[1]
  std = jax.random.uniform(rng_std, (bs, 1, 1), minval=0.0,
                           maxval=input_noise_std)
  noise = jax.random.normal(rng_in, (bs, n, out_dim))
  order = jax.random.bernoulli(keys[1], text_prefix_prob, (bs,))
  return order, rgb, noisy, std, noise


def _rows(workdir):
  with open(workdir / "big_vision_metrics.txt") as f:
    return [r for r in map(json.loads, f) if "training_loss" in r]


def test_smoke_twin_tracks_the_jax_trainer(tmp_path):
  steps = 2
  arg = f"total_steps={steps}"
  config = t_smoke.get_config(arg)
  config["model"]["drop_labels_probability"] = 0.0
  config.update(log_training_steps=1, evals={})
  init = tmp_path / "init.npz"
  trainer = t_jf_train.Trainer(config, device="cpu")
  with torch.no_grad():  # heads that are not zero, a flow that is not
    g = torch.Generator().manual_seed(1)  # the identity
    for p in (trainer.model.model.img_head.weight,
              trainer.model.adaptor.couplings.layer.dnn.final_proj.weight):
      p.copy_(0.05 * torch.randn(p.shape, generator=g))
  checkpoints.npz_save(convert.params(trainer.model), str(init))
  del trainer

  jax_config = j_smoke.get_config(arg)
  jax_config.model.drop_labels_probability = 0.0
  # Assigned, not passed to `update`, which would merge the eval in.
  jax_config.update(model_init=str(init), log_training_steps=1)
  jax_config.evals = {}
  j_jf_train.main(config=jax_config, workdir=str(tmp_path / "jax"))

  class Twin(t_jf_train.Trainer):
    def draws(self, batch, generator, train=True):
      count = t_optim.get_count(self.opt_state)
      d = _jax_draws(self.config, count, batch["image"].numpy(),
                     self.model.model.out_dim)
      d["dequant"] = self.patch_pca.unflatten_patches(d.pop("dequant_flat"))
      return d

  config.update(model_init=str(init))
  t_train.train(config, str(tmp_path / "port"), device="cpu",
                trainer_cls=Twin)
  jax_rows, port_rows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
  assert [r["step"] for r in jax_rows] == list(range(1, steps + 1))
  assert [r["step"] for r in port_rows] == list(range(1, steps + 1))
  keys = [k for k in jax_rows[0] if k.startswith(("train/", "l2_"))
          and math.isfinite(jax_rows[0][k])]
  assert "train/nll_image" in keys and "l2_params_adaptor" in keys
  for key in ["training_loss", "noise_scale"] + keys:
    for jr, pr in zip(jax_rows, port_rows):
      rel = abs(pr[key] - jr[key]) / max(abs(jr[key]), 1e-12)
      assert rel <= 1e-4, (key, jr["step"], pr[key], jr[key])
