"""PyTorch/CUDA port of gromacs_fep_gpu_tpu for one NVIDIA H100.

Module names mirror the JAX package (core/, models/, ops/, md/); each
module's docstring names the JAX file and functions it mirrors.  The
package imports torch and numpy only, never jax or gromacs_fep_gpu_tpu.
Entry points default to device="cuda"; the CPU is used only when the
caller passes device="cpu".  Hand-written CUDA kernels live in csrc/ and
are built with nvcc at first use (ops/cuda_lib.py).

Coordinate math stays in float32 with TF32 off: the JAX package lost
boundary atoms by whole boxes to reduced-precision coordinate products.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
