"""The port's interactive PaliGemma runner, end to end on the CPU.

`run.main` with a tiny model (a mu/16 tower at 32px plus `gemma_test`) set
through its module constants `MODEL_CFG` and `TOKENIZER`: a checkpoint the
JAX package writes (and, for int8 weights, one that the port's
`quantize_ckpt` rewrites), a synthetic JPEG, a hand-written unigram vocab,
and two prompts on stdin. Each printed answer must be the string the JAX
package gets for the same example: its pp string, its model's greedy
decode on the same params and its tokenizer's `to_str`.
"""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image
import pytest

from big_vision_torch.pp import sentencepiece_native as t_spn
from big_vision_torch.tools import quantize_ckpt
from big_vision_torch.trainers.proj.paligemma import run
from big_vision_tpu.models.ppp import gemma as j_gemma
from big_vision_tpu.models.proj.paligemma import paligemma as j_pg
from big_vision_tpu.models.proj.paligemma import predict_fns as j_pf
from big_vision_tpu.pp import builder as j_builder
from big_vision_tpu.pp import tokenizer as j_tok
import big_vision_tpu.pp.ops_general  # noqa: F401
import big_vision_tpu.pp.ops_image  # noqa: F401
import big_vision_tpu.pp.proj.paligemma.ops  # noqa: F401
from big_vision_tpu.utils import checkpoints as j_ckpt

RES, PREFILL, DECODE = 32, 8, 6
PROMPTS = ["caption en", "what is this"]
WORDS = ["caption", "en", "what", "is", "this", "a", "cat", "on", "the",
         "mat", "dog", "red"]


def write_vocab(path, size=256):
  """Gemma's special ids (pad 0, eos 1, bos 2, unk 3), then words, then
  filler pieces up to `size`."""
  pieces = [("<pad>", 0.0, t_spn.CONTROL), ("</s>", 0.0, t_spn.CONTROL),
            ("<s>", 0.0, t_spn.CONTROL), ("<unk>", 0.0, t_spn.UNKNOWN),
            ("\n", -1.0, t_spn.USER_DEFINED)]
  pieces += [(f"▁{w}", -2.0, t_spn.NORMAL) for w in WORDS]
  pieces += [(f"▁w{i}", -5.0, t_spn.NORMAL)
             for i in range(size - len(pieces))]
  path.write_bytes(t_spn.serialize_model_proto(
      pieces, unk_id=3, bos_id=2, eos_id=1, pad_id=0))
  return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
  tmp = tmp_path_factory.mktemp("run")
  rs = np.random.RandomState(0)
  img = dict(variant="mu/16", pool_type="none", scan=True)
  llm = dict(variant="gemma_test")
  jmodel = j_pg.Model(img=img, llm=llm)
  shapes = jax.eval_shape(lambda: jmodel.init(
      jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)),
      jnp.zeros((1, PREFILL), jnp.int32), jnp.zeros((1, PREFILL), jnp.int32)))
  params = jax.tree.map(
      lambda s: (rs.randn(*s.shape) * 0.3).astype(np.float32),
      shapes["params"])
  ckpt = str(tmp / "tiny.npz")
  j_ckpt.npz_save(params, ckpt)
  jpeg = io.BytesIO()
  Image.fromarray(rs.randint(0, 256, (40, 48, 3), dtype=np.uint8)).save(
      jpeg, format="JPEG", quality=90)
  image = tmp / "image.jpg"
  image.write_bytes(jpeg.getvalue())
  return dict(params=params, ckpt=ckpt, image=str(image), img=img, llm=llm,
              vocab=write_vocab(tmp / "vocab.model"), tmp=tmp)


def jax_answers(files, quant):
  """What the JAX package answers: its pp, model and tokenizer."""
  tok = f"gemma(tokensets=['loc', 'seg'], model={files['vocab']!r})"
  pp = j_builder.get_preprocess_fn("|".join([
      f"decode|resize({RES})|value_range(-1, 1)",
      f"tok(key='prefix', bos='yes', model={tok!r})",
      f"tok(key='septok', text='\\n', model={tok!r})",
      "masked_concat(['prefix', 'septok'], mask_ar=[0, 0],"
      " mask_input=[1, 1])",
      f"tolen({PREFILL}, pad_value=0, key='text')",
      f"tolen({PREFILL}, pad_value=1, key='mask_ar')",
      f"tolen({PREFILL}, pad_value=0, key='mask_input')",
      "keep('image', 'text', 'mask_ar', 'mask_input')"]))
  params = dict(files["params"])
  llm = dict(files["llm"], quant=quant)
  if quant:
    params["llm"] = j_gemma.quantize_params(
        j_gemma.scan_to_pyloop(params["llm"]))
    llm["scan"] = False
  jmodel = j_pg.Model(img=files["img"], llm=llm)
  decode = j_pf.make_predict_fns(jmodel, max_decode_len=DECODE)["decode"]
  image = open(files["image"], "rb").read()
  out = []
  for prompt in PROMPTS:
    ex = pp({"image": image, "prefix": np.array(prompt)})
    batch = {k: jnp.asarray(np.asarray(v)[None]) for k, v in ex.items()}
    tokens = decode({"params": params}, batch)
    out.append(j_tok.get_tokenizer(tok).to_str(np.asarray(tokens)[0]))
  return out


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_runner_answers_as_jax(files, quant, monkeypatch, capsys):
  ckpt = files["ckpt"]
  if quant:  # the LLM rewritten in int8 by the port's tool
    ckpt = str(files["tmp"] / "tiny-int8.npz")
    quantize_ckpt.main(["--ckpt", files["ckpt"], "--subtree", "llm",
                        "--out", ckpt])
  monkeypatch.setattr(run, "TOKENIZER", f"gemma(tokensets=['loc', 'seg'], "
                      f"model={files['vocab']!r})")
  monkeypatch.setattr(run, "MODEL_CFG", dict(
      img=files["img"],
      llm=dict(files["llm"], vocab_size=256, decode_impl="flash",
               quant=quant)))
  monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(PROMPTS) + "\n"))
  capsys.readouterr()
  run.main(["--ckpt", ckpt, "--image", files["image"], "--res", str(RES),
            "--max_decode_len", str(DECODE), "--prefill_len", str(PREFILL)],
           device="cpu")
  lines = capsys.readouterr().out.splitlines()
  assert lines == jax_answers(files, quant)
  assert all(lines), lines  # each answer decodes to words


def test_runner_refuses_to_start_without_a_card(files, monkeypatch):
  monkeypatch.setattr("torch.cuda.is_available", lambda: False)
  with pytest.raises(SystemExit, match="no CUDA"):
    run.main(["--ckpt", files["ckpt"], "--image", files["image"]])
