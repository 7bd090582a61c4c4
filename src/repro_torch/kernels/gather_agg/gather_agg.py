"""``ctypes`` binding of the CUDA ``gather_agg`` kernel
(``csrc/gather_agg.cu``), forward only.

Replaces the TPU kernel ``repro/kernels/gather_agg/gather_agg.py``
``_kernel`` / ``gather_agg``. The TPU grid walks the fan-out axis in
order; here block (i, c) owns dst row i and 128 feature columns and each
thread loops over the fan-out in order, with no atomics. Bound: bytes,
the distinct source rows the unmasked edges reference plus the output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "gather_agg"

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def launch_gather_agg(h: torch.Tensor, edge_src: torch.Tensor,
                      edge_mask: torch.Tensor, nd: int, fanout: int,
                      out: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream; inputs pre-checked by
    the wrapper (nd >= 1, d >= 1, float32/int32/bool contiguous)."""
    fn = library(FAMILY).repro_gather_agg
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        err = fn(h.data_ptr(), h.shape[1], edge_src.data_ptr(),
                 edge_mask.data_ptr(), nd, fanout, out.data_ptr(),
                 stream_handle(h.device))
    check(FAMILY, "gather_agg", err)
