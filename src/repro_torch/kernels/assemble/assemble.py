"""``ctypes`` binding of the CUDA select kernel (``csrc/assemble.cu``).

Replaces the TPU kernel ``repro/kernels/assemble/assemble.py``
``_select_kernel`` / ``assemble``. One warp per output row resolves the
row's source (local shard > cache hit > pulled) from the query id and
the ``search`` outputs, then copies only the winning row, in 16-byte
vectors where both rows are 16-byte aligned. Bound: bytes, one row read
and one row written per query.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "assemble"

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]


def launch_select(table: torch.Tensor, base: int, cache_feats: torch.Tensor,
                  pulled: torch.Tensor, query: torch.Tensor,
                  pos: torch.Tensor, hit: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Enqueue the select kernel on the current stream; inputs pre-checked
    by the wrapper (m >= 1, n_hot >= 1, float32/int32/bool contiguous)."""
    fn = library(FAMILY).repro_assemble_select
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    m, d = pulled.shape
    with torch.cuda.device(pulled.device):
        err = fn(table.data_ptr(), table.shape[0], int(base),
                 cache_feats.data_ptr(), cache_feats.shape[0],
                 pulled.data_ptr(), query.data_ptr(), pos.data_ptr(),
                 hit.data_ptr(), out.data_ptr(), m, d,
                 stream_handle(pulled.device))
    check(FAMILY, "assemble", err)
