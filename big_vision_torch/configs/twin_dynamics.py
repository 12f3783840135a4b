"""The loss-curve twin's config: port of
big_vision_tpu/configs/twin_dynamics.py.

  python -m big_vision_torch.train --workdir wd \
      --config big_vision_torch/configs/twin_dynamics.py:side=my,npz=<f.npz>

One config drives the JAX trainer and the port's on the same arrays
(`npz`: "image" [N, 32, 32, 3] f32 and one-hot "labels" [N, 10], as the JAX
package's tools/dynamics_twin.py `make_data` writes them), so a loss curve
that matches step for step means the two training loops match. Built to
leave nothing to chance: no shuffle (a buffer of 1 keeps the order of the
`arrays` source's epoch permutation), no mixup, dropout 0, an empty pp; the
init is the one thing both sides must share (a `model_init` file).

Kept as there: the args of `_parse` (`side`, `npz`, `steps`, `batch`,
`width`, `depth`, `lr`, `wd`), seed 0, 10 classes, `sigmoid_xent`, the ViT
(4 heads, MLP 4 x width, 4x4 patches at 32px: T = 64, D = width / 4,
learned posemb, GAP, no pre-logits layer), scale_by_adam, gradient clip
1.0, warmup max(1, min(20, steps // 5)) then cosine, a metric row every
step, no evals, pp_modules ["ops_general"].

Cut (`CUTS`): side=ref, the JAX package's reference side, which reads the
arrays through a `bv:` data source hook the port does not have; it is
refused by name.

Arg besides the JAX config's: `attn` (the attention impl, when not "auto":
at width 128 "auto" runs K1 and K2 in f32 at T = 64, D = 32; "xla" the
plain path).
"""

CUTS = {"side=ref": "the reference's `bv:twin_data` source hook is not "
                    "ported; side=ref is refused"}


def _parse(arg):
  out = dict(side="my", npz="", steps=200, batch=64,
             width=128, depth=2, lr=1e-3, wd=1e-4, attn="auto")
  for kv in (arg or "").split(","):
    if not kv:
      continue
    k, v = kv.split("=", 1)
    assert k in out, f"unknown twin arg {k!r}"
    out[k] = type(out[k])(v)
  return out


def get_config(arg=None):
  a = _parse(arg)
  if a["side"] != "my":
    raise ValueError(f"side={a['side']!r} is not ported: the port has no "
                     "`bv:` data source hook; use side=my")
  c = {}
  c["seed"] = 0
  c["total_steps"] = a["steps"]
  c["num_classes"] = 10
  c["loss"] = "sigmoid_xent"

  c["input"] = dict(
      batch_size=a["batch"],
      pp="",
      # A buffer of 1 keeps the source's order.
      shuffle_buffer_size=1,
      data=dict(name="arrays", npz=a["npz"]),
  )
  c["pp_modules"] = ["ops_general"]

  c["log_training_steps"] = 1
  c["evals"] = {}

  c["model_name"] = "vit"
  c["model"] = dict(width=a["width"], depth=a["depth"],
                    mlp_dim=4 * a["width"], num_heads=4, patch_size=(4, 4),
                    posemb="learn", pool_type="gap", rep_size=False,
                    dropout=0.0)
  if a["attn"] != "auto":
    c["model"]["attn_impl"] = a["attn"]

  c["optax_name"] = "scale_by_adam"
  c["grad_clip_norm"] = 1.0
  c["lr"] = a["lr"]
  c["wd"] = a["wd"]
  c["schedule"] = dict(warmup_steps=max(1, min(20, a["steps"] // 5)),
                       decay_type="cosine")
  return c
