"""The port imports nothing of the JAX package, JAX or its libraries.

Every module of `big_vision_torch`, and `chip_smoke.py`, is imported in a
fresh interpreter in which `jax`, `flax`, `optax`, `ml_collections` and
`big_vision_tpu` are blocked (set to None in `sys.modules`, so importing
them raises), and with them `transformers` and `tensorflow`, which the
card's machine lacks (the port's WordPiece and BERT need neither); and no
import statement of theirs, at any depth, names one.
"""

import ast
import os
import subprocess
import sys

_SCRIPT = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "ml_collections", "big_vision_tpu",
             "transformers", "tensorflow"):
  sys.modules[name] = None
import big_vision_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    big_vision_torch.__path__, "big_vision_torch."))
for name in names:
  importlib.import_module(name)
print(" ".join(names))
"""


def test_port_imports_without_jax():
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["PYTHONPATH"] = root
  out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr[-3000:]
  names = out.stdout.strip().splitlines()[-1].split()
  assert len(names) >= 30
  for name in ("utils.checkpoints", "evaluators.proj.distill.distance",
               "trainers.proj.flexi.distill",
               "configs.proj.flexivit.i21k_distill", "utils.chrono",
               "evaluators.fewshot_lsr", "configs.common_fewshot",
               "configs.proj.flexivit.i1k_deit3_distill",
               "trainers.proj.distill.distill", "configs.proj.distill.smoke",
               "tools.quantize_ckpt", "pp.tokenizer",
               "pp.sentencepiece_native", "pp.proj.paligemma.ops",
               "trainers.proj.paligemma.predict_fns",
               "trainers.proj.paligemma.run", "pp.autoaugment",
               "models.mlp_mixer", "configs.vit_s16_i1k", "configs.vit_i1k",
               "configs.mlp_mixer_i1k", "configs.transfer",
               "datasets.arrays", "datasets.digits", "configs.quality_digits",
               "configs.twin_dynamics", "configs.vit_i21k",
               "configs.proj.gsam.smoke",
               "configs.proj.gsam.vit_i1k_gsam_no_aug",
               "trainers.proj.gsam.gsam", "trainers.proj.gsam.train",
               "tools.step_timing", "pp.ops_text",
               "pp.proj.flaxformer.bert_ops", "models.proj.flaxformer.bert",
               "models.proj.image_text.two_towers",
               "models.proj.image_text.text_transformer",
               "parallel.contrastive", "trainers.proj.image_text.siglip",
               "evaluators.proj.image_text.retrieval",
               "evaluators.proj.image_text.contrastive", "evaluators.mean",
               "evaluators.save", "evaluators.classification_with_labelmap",
               "configs.proj.image_text.siglip_lit_coco",
               "configs.load_and_eval", "configs.proj.flexi.smoke",
               "tools.eval_only", "models.convnets", "models.bit",
               "models.bit_paper", "configs.bit_i1k", "configs.bit_i21k",
               "configs.proj.distill.common", "configs.proj.distill.bit_i1k",
               "configs.proj.distill.bigsweep_flowers_pet",
               "configs.proj.distill.bigsweep_food_sun",
               "evaluators.proj.distill.cka", "pp.archive.autoaugment",
               "pp.archive.randaug"):
    assert f"big_vision_torch.{name}" in names, name


_BLOCKED = ("jax", "flax", "optax", "ml_collections", "big_vision_tpu",
            "transformers", "tensorflow")


def _imported_modules(path):
  """Every module that an import statement of the file names, at any
  depth (function-level imports included)."""
  tree = ast.parse(open(path).read(), filename=path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module


def test_no_jax_import_statement_in_the_port_or_chip_smoke():
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  paths = [os.path.join(root, "chip_smoke.py")]
  for base, _, files in os.walk(os.path.join(root, "big_vision_torch")):
    paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
  assert len(paths) > 30
  for path in paths:
    for name in _imported_modules(path):
      assert name.split(".")[0] not in _BLOCKED, (path, name)


def test_chip_smoke_imports_without_jax():
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["PYTHONPATH"] = root
  script = ("import sys\n"
            f"for name in {_BLOCKED!r}:\n"
            "  sys.modules[name] = None\n"
            "import chip_smoke\n"
            "print(chip_smoke.TRAIN_CONFIG)\n")
  out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr[-3000:]
  assert out.stdout.strip().endswith("vit_b16_synthetic.py")
