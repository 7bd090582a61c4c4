"""``ctypes`` binding of the CUDA one-sweep radix sort
(``csrc/radix_sort.cu``).

Replaces the TPU kernel ``repro/kernels/seg_sort/seg_sort.py``
``_radix_pass_kernel`` / ``radix_sort``, which keeps the whole key
vector in VMEM (at most 2^19 keys) and runs one grid step per 4-bit
pass. Here the keys stay in HBM and a call is ``1 + passes(num_bits)``
launches: one counts every 8-bit pass's digits into a per-card
histogram; then one launch a pass in clusters of ``CLUSTER`` blocks,
each block a tile of ``TILE`` keys (one TMA bulk copy), ranked stably
(``THREADS`` threads, a warp a run of ``32 * ROUNDS`` keys). A
cluster's tiles scan their digit counts through distributed shared
memory, and a decoupled look-back over the earlier clusters gives the
cluster's offsets. No size limit; bound: bytes.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import (check, library, multiprocessors,
                                        stream_handle)

FAMILY = "seg_sort"

#: the kernel's plan, compiled into csrc/radix_sort.cu (mirrored here)
THREADS = 256
ROUNDS = 18
TILE = THREADS * ROUNDS
CLUSTER = 8
DIGIT_BITS = 8

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

#: per card: the global digit histogram, int32 zeros that every call
#: leaves zero again (so calls on one stream at a time, as the port makes
#: them)
_hist: Dict[int, torch.Tensor] = {}


def passes(num_bits: int) -> int:
    """``DIGIT_BITS``-bit passes over ``num_bits``-bit keys plus the bit
    that ranks every key at or above ``2^num_bits`` last."""
    return -(-min(num_bits + 1, 32) // DIGIT_BITS)


def _hist_buffer() -> torch.Tensor:
    idx = torch.cuda.current_device()
    if idx not in _hist:
        fn = library(FAMILY).repro_radix_sort_hist_len
        fn.restype = ctypes.c_int
        _hist[idx] = torch.zeros(fn(), dtype=torch.int32, device=idx)
    return _hist[idx]


def launch_radix_sort(keys: torch.Tensor, payload: Optional[torch.Tensor],
                      keys_out: torch.Tensor,
                      payload_out: Optional[torch.Tensor],
                      num_bits: int) -> None:
    """Enqueue the launches on the current stream; inputs pre-checked by
    the wrapper (n >= 1, 1 <= num_bits <= 31, int32 contiguous, one
    device). Scratch (the look-back status words, the cluster tickets and
    a ping-pong copy of keys and payload) comes from PyTorch's
    allocator."""
    n = keys.shape[0]
    lib = library(FAMILY)
    size = lib.repro_radix_sort_scratch_bytes
    size.argtypes = [ctypes.c_int] * 2
    size.restype = ctypes.c_longlong
    scratch = torch.empty(-(-size(n, num_bits) // 8),
                          dtype=torch.int64, device=keys.device)
    keys_tmp = torch.empty_like(keys)
    pay_tmp = None if payload is None else torch.empty_like(payload)

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = lib.repro_radix_sort
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(keys.device):
        hist = _hist_buffer()
        err = fn(keys.data_ptr(), ptr(payload), keys_out.data_ptr(),
                 ptr(payload_out), keys_tmp.data_ptr(), ptr(pay_tmp),
                 scratch.data_ptr(), hist.data_ptr(), n, num_bits,
                 multiprocessors(keys.device), stream_handle(keys.device))
        if err:  # a refused pass may leave counts: the next call starts anew
            _hist.pop(torch.cuda.current_device())
    check(FAMILY, "radix_sort", err)
