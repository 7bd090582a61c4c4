"""``ctypes`` binding of the CUDA radix sort (``csrc/radix_sort.cu``).

Replaces the TPU kernel ``repro/kernels/seg_sort/seg_sort.py``
``_radix_pass_kernel`` / ``radix_sort``, which keeps the whole key
vector in VMEM (at most 2^19 keys) and runs one grid step per 4-bit
pass. Here the keys stay in HBM: each 8-bit pass is a per-block digit
histogram, a per-digit exclusive scan of those counts and a stable
scatter at offsets in (digit, block) order, with no atomics and no size
limit. Bound: bytes, the keys read
twice and written once per pass, the payload read and written once.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "seg_sort"

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]


def scratch_len(n: int) -> int:
    """int32 entries of the digit-count scratch for ``n`` keys."""
    fn = library(FAMILY).repro_radix_sort_scratch_len
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(n))


def launch_radix_sort(keys: torch.Tensor, payload: Optional[torch.Tensor],
                      keys_out: torch.Tensor,
                      payload_out: Optional[torch.Tensor],
                      num_bits: int) -> None:
    """Enqueue the passes on the current stream; inputs pre-checked by
    the wrapper (n >= 1, 1 <= num_bits <= 31, int32 contiguous, one
    device). Scratch comes from PyTorch's allocator."""
    n = keys.shape[0]
    keys_tmp = torch.empty_like(keys)
    pay_tmp = None if payload is None else torch.empty_like(payload)
    scratch = torch.empty(scratch_len(n), dtype=torch.int32,
                          device=keys.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = library(FAMILY).repro_radix_sort
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(keys.device):
        err = fn(keys.data_ptr(), ptr(payload), keys_out.data_ptr(),
                 ptr(payload_out), keys_tmp.data_ptr(), ptr(pay_tmp),
                 scratch.data_ptr(), n, num_bits,
                 stream_handle(keys.device))
    check(FAMILY, "radix_sort", err)
