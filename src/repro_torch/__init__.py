"""PyTorch/CUDA port of the RapidGNN system for NVIDIA Hopper (H100).

A package of its own beside the JAX reference package ``repro``: it
imports ``torch`` and ``numpy`` and nothing of ``jax`` or ``repro``.
Host-side numpy modules it needs are kept here as its own copies, under
the same relative paths. Every Pallas kernel on a ported path becomes a
CUDA C++ kernel for ``sm_90a`` under ``kernels/<family>/csrc``.

float32 matrix products and convolutions run in full float32: TF32 is
switched off for both (``allow_tf32 = False``), so the port's numbers
are comparable with the float32 reference.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
