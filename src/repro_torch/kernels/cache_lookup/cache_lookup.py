"""``ctypes`` binding of the CUDA ``search`` kernel (``csrc/search.cu``).

Replaces the TPU kernel ``repro/kernels/cache_lookup/cache_lookup.py``
``_search_kernel`` / ``search`` (a comparison-mask sum over
(Tq x Tc) tiles). On Hopper one thread per query runs a lower-bound
binary search over the sorted ids, which stay in L1/L2; the bound is the
few hundred KB of query/pos/hit bytes, so the design keeps the grid wide
(one thread per query) and reads each query once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "cache_lookup"

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def launch_search(cache_ids: torch.Tensor, query: torch.Tensor,
                  pos: torch.Tensor, hit: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream; inputs pre-checked by
    the wrapper (n_hot >= 1, m >= 1, int32/bool contiguous)."""
    fn = library(FAMILY).repro_search
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(query.device):
        err = fn(cache_ids.data_ptr(), cache_ids.shape[0], query.data_ptr(),
                 query.shape[0], pos.data_ptr(), hit.data_ptr(),
                 stream_handle(query.device))
    check(FAMILY, "search", err)
