"""``ctypes`` binding of the CUDA ``flash_attention`` kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_wgmma.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention/
flash_attention.py`` ``_kernel`` / ``flash_attention``: a
(B, kvH, nq, nk) grid whose innermost axis walks the KV tiles in order
and carries (m, l, acc) in VMEM scratch. Here one block owns one
(b, kv head) and a tile of rows of the flattened (query position, group
head) axis, so any group size G fits one tile shape; it walks its KV
tiles in a loop, from the first key the window admits to the last the
causal mask admits (the last of k/v's own length Skv without a mask),
holding (m, l, acc) in registers. The C entry point
dispatches by dtype: bfloat16 runs on the tensor cores through warpgroup
MMA (bf16 products with float32 accumulators, p split into two bf16
terms for P.V; a producer warp loads K/V by TMA into a two-stage
``mbarrier`` ring, two consumer warpgroups of 64 rows take turns at the
tensor cores; the tensor maps are encoded for each call), float32 on
the CUDA cores. The bound is the operations: ``4 dh`` FLOP per valid
(q head, key) pair.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "flash_attention"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
         + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p])


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, out: torch.Tensor, *,
                           causal: bool, window: int, softcap: float,
                           scale: float) -> None:
    """Enqueue the kernel on the current stream; inputs pre-checked by
    the wrapper (B, S, Skv >= 1, Skv == S unless there is no mask;
    dh % 8 == 0, dh <= 256; one dtype of float32/bfloat16; contiguous,
    16-byte aligned)."""
    B, S, H, dh = q.shape
    fn = library(FAMILY).repro_flash_attention
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, S, k.shape[1], H, k.shape[2], dh,
                 float(scale), float(softcap), int(bool(causal)),
                 int(window), stream_handle(q.device))
    check(FAMILY, "flash_attention", err)
