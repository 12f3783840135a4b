"""PyTorch/CUDA port of big_vision_tpu for NVIDIA Hopper (H100).

The JAX package `big_vision_tpu` is the reference; this package mirrors its
module paths so each counterpart is easy to find. It imports torch, never
jax, flax or anything of `big_vision_tpu`. Entry points run on the GPU
(`device="cuda"`) unless the caller asks for the CPU, where every kernel
wrapper takes its plain PyTorch version.
"""
