"""``ctypes`` binding of the CUDA ``flash_decode`` kernel
(``csrc/flash_decode.cu``).

Replaces the TPU kernel ``repro/kernels/flash_decode/flash_decode.py``
``_kernel`` / ``flash_decode``: a (kvH, S // ts) grid walking the cache
tiles in order with (m, l, acc) in VMEM scratch, one batch element per
call (the JAX wrapper vmaps it). Here one launch takes the whole batch:
block (b*kvH + h, split) owns one kv head's G query heads over the
split-th equal part of the element's own valid range ``[start,
length)``; inside it, groups of lanes stream their own keys, up to eight
in flight, with their own running (m, l, acc), merged at the end. More
than 8 q heads a kv head are cut into ``head_slices`` of at most 8, a
block each. With
one split the block writes the result itself; with more, the last block
of each (b, kv head) to finish, told by an integer ticket, combines the
splits in split order (the TPU kernel's own (acc, m, l) contract) and
normalises, in the same launch. Bound: bytes, the valid K/V rows read
once.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (check, library, multiprocessors,
                                        stream_handle)

FAMILY = "flash_decode"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: blocks to aim for across the card when splitting the cache
BLOCKS_PER_SM = 8
#: fewest cache positions a split is given
MIN_SPLIT = 512

#: the most q heads one block holds (its running state in registers)
SLICE_HEADS = 8

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
         + [ctypes.c_float, ctypes.c_float, ctypes.c_int]
         + [ctypes.c_void_p] * 9)

#: the split tickets of each card: int32 zeros that every launch leaves
#: zero again (so calls on one stream at a time, as the port makes them)
_tickets = {}


def head_slices(G: int) -> int:
    """The fewest equal slices of a kv head's G q heads with at most
    ``SLICE_HEADS`` heads each (16 -> 2 of 8)."""
    n = -(-G // SLICE_HEADS)
    while G % n:
        n += 1
    return n


def plan_splits(pairs: int, S: int, sms: int) -> int:
    """Slices of each element's valid range per (b, kv head, head slice)
    column of blocks, ``pairs`` of them: enough that
    the grid holds about ``BLOCKS_PER_SM`` blocks a multiprocessor, and no
    more than one per ``MIN_SPLIT`` cache positions. A function of the
    shapes only, never of the lengths (which live on the card)."""
    want = -(-BLOCKS_PER_SM * sms // max(pairs, 1))
    return max(1, min(want, -(-S // MIN_SPLIT)))


def split_range(start: int, length: int, S: int, n_split: int,
                split: int):
    """[lo, hi) of split ``split``: the kernel's cut of the valid range
    ``[max(start, 0), min(length, S))`` into ``n_split`` parts of
    ``ceil(n / n_split)`` positions (the last ones may be short or
    empty)."""
    lo_b, hi_b = max(start, 0), min(length, S)
    n = max(hi_b - lo_b, 0)
    chunk = -(-n // n_split)
    return lo_b + min(split * chunk, n), lo_b + min((split + 1) * chunk, n)


def split_plan(pairs: int, S: int, device: torch.device) -> int:
    """``plan_splits`` for the card ``device``."""
    return plan_splits(pairs, S, multiprocessors(device))


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    buf = _tickets.get(idx)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[idx] = buf
    return buf


def launch_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        length: torch.Tensor, start: Optional[torch.Tensor],
                        *, scale: float, softcap: float,
                        acc: Optional[torch.Tensor] = None,
                        m: Optional[torch.Tensor] = None,
                        l: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None) -> None:
    """Enqueue the kernel, one launch, on the current stream.
    q (B,H,dh), k/v (B,S,kvH,dh), length/start (B,) int32, pre-checked
    by the wrapper. Writes the combined partials into ``acc``/``m``/``l``
    when given, and the normalised float32 output into ``out`` when
    given."""
    B, H, dh = q.shape
    S, kvH = k.shape[1], k.shape[2]
    slices = head_slices(H // kvH)
    n_split = split_plan(B * kvH * slices, S, q.device)
    if n_split > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part_acc = torch.empty((n_split, B, H, dh), **f32)
        part_m = torch.empty((n_split, B, H), **f32)
        part_l = torch.empty((n_split, B, H), **f32)
        tickets = _ticket_buffer(q.device, B * kvH * slices)
    else:
        part_acc = part_m = part_l = tickets = None

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = library(FAMILY).repro_flash_decode
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 length.data_ptr(), ptr(start), _DTYPES[q.dtype], B, S, H,
                 kvH, dh, slices, float(scale), float(softcap), n_split,
                 ptr(part_acc), ptr(part_m), ptr(part_l), ptr(tickets),
                 ptr(acc), ptr(m), ptr(l), ptr(out),
                 stream_handle(q.device))
    check(FAMILY, "flash_decode", err)
