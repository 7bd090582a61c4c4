"""``ctypes`` bindings of the CUDA ``search`` (``csrc/search.cu``) and
``merge_gather`` (``csrc/merge_gather.cu``) kernels.

``search`` replaces the TPU kernel
``repro/kernels/cache_lookup/cache_lookup.py`` ``_search_kernel`` /
``search`` (a comparison-mask sum over (Tq x Tc) tiles). On Hopper each
block of a persistent grid (at most 2 a multiprocessor) copies a
splitter table into shared memory, the last id of every segment of
``seg`` ids (one 128-byte line of 32 ids up to n_hot 65,536, at most
2,048 words); each thread binary-searches the table,
then takes its query's lower bound inside that one segment (one line,
one L1/L2 miss). The bound is the few hundred KB of query/pos/hit
bytes, below one launch's cost: on the main path the rank is folded
into the fused assembly kernel instead.

``merge_gather`` replaces ``_merge_kernel`` / ``merge_gather`` of the
same file (one cache row per grid step, merged over the pre-filled base).
On Hopper one warp per output row copies only the winning row (the cache
row on a hit, the base row otherwise) in the widest vector its alignment
allows; the bound is bytes, one row read and one row written per query.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "cache_lookup"

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

_MERGE_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

#: dtype codes of ``csrc/merge_gather.cu``
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def launch_merge_gather(cache_feats: torch.Tensor, base: torch.Tensor,
                        pos: torch.Tensor, hit: torch.Tensor,
                        out: torch.Tensor) -> None:
    """Enqueue the merge kernel on the current stream; inputs pre-checked
    by the wrapper (n_hot >= 1, m >= 1, d >= 1, float32/bfloat16 rows,
    int32 pos, bool hit, all contiguous)."""
    fn = library(FAMILY).repro_merge_gather
    fn.argtypes = _MERGE_ARGS
    fn.restype = ctypes.c_int
    m, d = base.shape
    with torch.cuda.device(base.device):
        err = fn(cache_feats.data_ptr(), cache_feats.shape[0],
                 DTYPE_CODES[cache_feats.dtype], base.data_ptr(),
                 pos.data_ptr(), hit.data_ptr(), out.data_ptr(),
                 DTYPE_CODES[out.dtype], m, d, stream_handle(base.device))
    check(FAMILY, "merge_gather", err)
