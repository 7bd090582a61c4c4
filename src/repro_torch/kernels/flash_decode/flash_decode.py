"""``ctypes`` binding of the CUDA ``flash_decode`` kernels
(``csrc/flash_decode.cu``).

Replaces the TPU kernel ``repro/kernels/flash_decode/flash_decode.py``
``_kernel`` / ``flash_decode``: a (kvH, S // ts) grid walking the cache
tiles in order with (m, l, acc) in VMEM scratch, one batch element per
call (the JAX wrapper vmaps it). Here one launch takes the whole batch:
block (b*kvH + h, split) owns one kv head's G query heads over one slice
of the cache; inside it, groups of lanes stream their own keys, four
in flight, with their own running (m, l, acc), merged at the end, and a second small
kernel combines the slices (the TPU kernel's own (acc, m, l) contract)
and normalises. Bound: bytes, the valid K/V rows read once.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "flash_decode"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: blocks to aim for across the card when splitting the cache
BLOCKS_PER_SM = 8
#: fewest cache positions a split is given
MIN_SPLIT = 512

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]
         + [ctypes.c_void_p] * 8)

_sms = {}


def split_plan(pairs: int, S: int, device: torch.device):
    """(n_split, chunk): slices of the cache per (b, kv head) so that the
    grid holds about ``BLOCKS_PER_SM`` blocks a multiprocessor, none
    shorter than ``MIN_SPLIT`` positions. Depends on shapes only, never
    on the lengths (which live on the card)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    want = -(-BLOCKS_PER_SM * _sms[idx] // max(pairs, 1))
    n_split = max(1, min(want, -(-S // MIN_SPLIT)))
    chunk = -(-S // n_split)
    return -(-S // chunk), chunk


def launch_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        length: torch.Tensor, start: Optional[torch.Tensor],
                        *, scale: float, softcap: float,
                        acc: Optional[torch.Tensor] = None,
                        m: Optional[torch.Tensor] = None,
                        l: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None) -> None:
    """Enqueue the partial and combine kernels on the current stream.
    q (B,H,dh), k/v (B,S,kvH,dh), length/start (B,) int32, pre-checked
    by the wrapper. Writes the combined partials into ``acc``/``m``/``l``
    when given, and the normalised float32 output into ``out`` when
    given."""
    B, H, dh = q.shape
    S, kvH = k.shape[1], k.shape[2]
    n_split, chunk = split_plan(B * kvH, S, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((n_split, B, H, dh), **f32)
    part_m = torch.empty((n_split, B, H), **f32)
    part_l = torch.empty((n_split, B, H), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = library(FAMILY).repro_flash_decode
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 length.data_ptr(), ptr(start), _DTYPES[q.dtype], B, S, H,
                 kvH, dh, float(scale), float(softcap), n_split, chunk,
                 part_acc.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                 ptr(acc), ptr(m), ptr(l), ptr(out),
                 stream_handle(q.device))
    check(FAMILY, "flash_decode", err)
