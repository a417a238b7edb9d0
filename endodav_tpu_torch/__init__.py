"""endodav_tpu_torch — the PyTorch/CUDA port of endodav_tpu for NVIDIA Hopper.

The JAX package `endodav_tpu` is the reference; each module here keeps the
name and layout of its counterpart there.  The port imports `torch` and
never `jax`, `flax` or `endodav_tpu`.  The two Pallas kernels of the
serving path are hand-written CUDA C++ under `csrc/`, built with nvcc at
first use (`kernels/_build.py`).
"""
