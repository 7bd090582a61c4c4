"""``ctypes`` binding of the CUDA fused assembly kernel
(``csrc/assemble.cu``).

Replaces the TPU path ``repro/kernels/assemble/assemble.py``
``assemble`` (``classify`` over the ``search`` kernel, then
``_select_kernel``) with one launch. One warp per output row tests the
row's query id against this worker's shard, ranks it over the sorted
hot-set ids with a warp-cooperative 32-ary search (``__ballot_sync`` a
level: 3 levels at n_hot 4,096 and 32,768) where it is not local, and
copies only the winning row (local shard > cache hit > pulled), in
16-byte vectors where both rows are 16-byte aligned. The rank never
leaves the warp. Bound: bytes, one row read and one row written per
query plus the queries and the ids once, ``2*m*d*4 + m*4 + n_hot*4``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "assemble"

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]


def launch_assemble(table: torch.Tensor, base: int,
                    cache_ids: torch.Tensor, cache_feats: torch.Tensor,
                    pulled: torch.Tensor, query: torch.Tensor,
                    out: torch.Tensor) -> None:
    """Enqueue the fused kernel on the current stream; inputs pre-checked
    by the wrapper (m >= 1, float32/int32 contiguous; ``n_hot`` 0
    assembles cache-less)."""
    fn = library(FAMILY).repro_assemble
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    m, d = pulled.shape
    with torch.cuda.device(pulled.device):
        err = fn(table.data_ptr(), table.shape[0], int(base),
                 cache_ids.data_ptr(), cache_feats.data_ptr(),
                 cache_ids.shape[0], pulled.data_ptr(), query.data_ptr(),
                 out.data_ptr(), m, d, stream_handle(pulled.device))
    check(FAMILY, "assemble", err)
