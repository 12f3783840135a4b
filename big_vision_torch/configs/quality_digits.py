"""ViT trained to a pinned quality on real handwritten digits: port of
big_vision_tpu/configs/quality_digits.py.

  python -m big_vision_torch.train \
      --config big_vision_torch/configs/quality_digits.py:npz_dir=<dir> \
      --workdir wd
  python -m big_vision_torch.train --device cpu --workdir wd \
      --config big_vision_torch/configs/quality_digits.py:runlocal=True,npz_dir=<dir>

The data are sklearn's bundled `load_digits` (1,797 8x8 scans, 10
classes), split as the JAX package's tools/run_quality.py splits them
(1437 train, 360 test). The port carries the scans itself
(`datasets/digits.npz`): the `arrays` source writes `digits_train.npz` and
`digits_test.npz` into `npz_dir` from them when they are absent, so no
sklearn is needed (`datasets.digits.make_split`).

Kept as there, all of it: `EXPECTED` (val/prec@1 >= 0.96 at 2000 steps),
the ViT (width 96, depth 6, MLP 384, 6 heads, 4x4 patches at 32px: T = 64
tokens of D = 16 under the attention gate "auto", so K1 and K2 in f32;
GAP, sincos2d posemb, a pre-logits layer, dropout 0.1), the pp
`resize(36)|random_crop(32)|value_range(-1, 1)|onehot|keep` (no flip),
batch 256, scale_by_adam with a bf16 first moment, gradient clip 1.0, lr
1e-3, wd 1e-4, 100 warmup steps then cosine, mixup p=0.5, checkpoints
every 500 steps, the classification eval every 200 steps, and `runlocal`
(40 steps, 10 warmup, evals every 20). The args are the JAX config's:
`res`, `total_steps`, `batch_size`, `npz_dir` and `runlocal`.

Nothing is cut (`CUTS` is empty).
"""

from big_vision_torch.configs import common

# The quality bar this recipe trains to (as in the JAX config).
EXPECTED = {"val/prec@1": 0.96}

CUTS = {}


def get_config(arg=None):
  arg = common.parse_arg(arg, res=32, total_steps=2000, batch_size=256,
                         npz_dir="/tmp/bvt_digits", runlocal=False)
  config = {}

  config["seed"] = 0
  config["total_steps"] = 40 if arg.runlocal else arg.total_steps
  config["num_classes"] = 10
  config["loss"] = "softmax_xent"
  config["init_shapes"] = [(1, arg.res, arg.res, 3)]
  config["expected"] = dict(EXPECTED)

  # No flip_lr: digits are not symmetric left to right (2/5, b/d).
  pp_train = (f"resize({arg.res + 4})|random_crop({arg.res})"
              "|value_range(-1, 1)"
              "|onehot(10, key='label', key_result='labels')"
              "|keep('image', 'labels')")
  config["input"] = dict(
      data=dict(name="arrays", npz=f"{arg.npz_dir}/digits_train.npz"),
      batch_size=arg.batch_size,
      shuffle_buffer_size=2048,
      num_threads=4,
      prefetch=2,
      pp=pp_train,
  )

  config["log_training_steps"] = 50
  config["ckpt_steps"] = 500

  config["model_name"] = "vit"
  config["model"] = dict(width=96, depth=6, mlp_dim=384, num_heads=6,
                         patch_size=(4, 4), rep_size=True, pool_type="gap",
                         posemb="sincos2d", dropout=0.1)

  config["grad_clip_norm"] = 1.0
  config["optax_name"] = "scale_by_adam"
  config["optax"] = dict(mu_dtype="bfloat16")
  config["lr"] = 1e-3
  config["wd"] = 1e-4
  config["schedule"] = dict(warmup_steps=10 if arg.runlocal else 100,
                            decay_type="cosine")
  config["mixup"] = dict(p=0.5)

  pp_eval = (f"resize({arg.res})|value_range(-1, 1)"
             "|onehot(10, key='label', key_result='labels')"
             "|keep('image', 'labels')")
  config["evals"] = dict(
      val=dict(type="classification",
               data=dict(name="arrays",
                         npz=f"{arg.npz_dir}/digits_test.npz"),
               pp_fn=pp_eval, loss_name=config["loss"],
               log_steps=200 if not arg.runlocal else 20),
  )
  return config
