"""clip_for_dl_tpu_torch — the PyTorch/CUDA port of clip_for_dl_tpu.

The zero-shot serving slice and the phase-A pretrain step run on an NVIDIA
Hopper GPU through six hand-written CUDA kernels (``csrc/``, built with nvcc
on first use). The JAX package ``clip_for_dl_tpu`` stays the reference; this
package imports torch and numpy and never jax, flax or ``clip_for_dl_tpu``.
"""

__version__ = "0.1.0"
