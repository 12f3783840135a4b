"""Distillation smoke config: a tiny teacher into a tiny student on
synthetic JPEGs, through the generic distill trainer.

  python -m big_vision_torch.trainers.proj.distill.distill --device cpu \
      --config big_vision_torch/configs/proj/distill/smoke.py:teacher_init=<teacher.npz> \
      --workdir wd

Source: big_vision_tpu/configs/proj/distill/smoke.py, as it is: ViT-mu/16
student and teacher "prof" (sincos2d posemb, no zero-init head) at 32px,
10 classes, 10 steps of batch 16, the input pp
`decode_jpeg_and_inception_crop(32)|flip_lr|value_range(-1, 1)|onehot`,
the distance "kl" with t=2, mixup p=0.2, scale_by_adam, lr 1e-3, wd 1e-4,
2 warmup steps then cosine, a checkpoint every 10 steps, and the evals
`val` (classification of the student) and `distance` (kl, euclidean and
top-1 agreement of the student's and the teacher's logits), with pp
`decode|resize(32)|...`, every 10 steps.

Nothing is cut. Its teacher is a checkpoint (`teacher_init`, the path of
an `.npz`): a test or a smoke run writes one with random weights.

`CUTS` is empty: no key differs from the JAX config.

Args (`:name=value,...`): `res` (32), `total_steps` (10), `batch_size`
(16), `teacher_init` (""), as in the JAX config.
"""

from big_vision_torch.configs import common

CUTS = {}  # nothing is cut


def get_config(arg=None):
  arg = common.parse_arg(arg, res=32, total_steps=10, batch_size=16,
                         teacher_init="")
  config = {}
  config["seed"] = 0
  config["total_steps"] = arg.total_steps
  config["num_classes"] = 10
  config["init_shapes"] = [(1, arg.res, arg.res, 3)]

  config["input"] = dict(
      data=dict(name="synthetic", n=64, num_classes=10, h=40, w=40),
      batch_size=arg.batch_size,
      shuffle_buffer_size=32, num_threads=4, prefetch=1,
      pp=(f"decode_jpeg_and_inception_crop({arg.res})|flip_lr"
          "|value_range(-1, 1)"
          "|onehot(10, key='label', key_result='labels')"
          "|keep('image', 'labels')"),
  )
  config["log_training_steps"] = 5
  config["ckpt_steps"] = 10

  config["student_name"] = "vit"
  config["student"] = dict(variant="mu/16", posemb="sincos2d",
                           head_zeroinit=False)
  config["teachers"] = ["prof"]
  config["prof_name"] = "vit"
  config["prof"] = dict(variant="mu/16", posemb="sincos2d",
                        head_zeroinit=False)
  config["prof_init"] = arg.teacher_init

  config["distance"] = "kl"
  config["distance_kw"] = dict(t=2.0)
  config["mixup"] = dict(p=0.2)

  config["optax_name"] = "scale_by_adam"
  config["lr"] = 1e-3
  config["wd"] = 1e-4
  config["schedule"] = dict(warmup_steps=2, decay_type="cosine")

  eval_pp = (f"decode|resize({arg.res})|value_range(-1, 1)"
             "|onehot(10, key='label', key_result='labels')"
             "|keep('image', 'labels')")
  eval_data = dict(name="synthetic", n=32, num_classes=10, h=40, w=40)
  config["evals"] = dict(
      val=dict(type="classification", pred="student_fwd", data=eval_data,
               pp_fn=eval_pp, loss_name="softmax_xent", log_steps=10),
      distance=dict(type="proj.distill.distance", pred="student_prof_fwd",
                    data=eval_data, pp_fn=eval_pp, log_steps=10,
                    distances=({"kind": "kl"}, {"kind": "euclidean"},
                               {"kind": "agree", "k": 1})),
  )
  return config
