"""GSAM trainer's entry point: port of
big_vision_tpu/trainers/proj/gsam/train.py (the module path of the JAX
package's command line; the trainer is in gsam.py).

  python -m big_vision_torch.trainers.proj.gsam.train --workdir <dir> \
      --config big_vision_torch/configs/proj/gsam/smoke.py [--device cpu]
"""

from big_vision_torch.trainers.proj.gsam.gsam import (  # noqa: F401
    dual_vector, gsam_gradient, main)

if __name__ == "__main__":
  main()
