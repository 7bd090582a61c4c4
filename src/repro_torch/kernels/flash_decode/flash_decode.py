"""``ctypes`` binding of the CUDA ``flash_decode`` kernels: bfloat16 at
G >= 2 on the tensor cores (``csrc/flash_decode_mma.cu``), float32 and
bfloat16 at G = 1 on the CUDA cores (``csrc/flash_decode.cu``), one C
entry point that takes the plan's choice.

Replaces the TPU kernel ``repro/kernels/flash_decode/flash_decode.py``
``_kernel`` / ``flash_decode``: a (kvH, S // ts) grid walking the cache
tiles in order with (m, l, acc) in VMEM scratch, one batch element per
call (the JAX wrapper vmaps it). Here one launch takes the whole batch:
block (column, split) owns one kv head's q heads over the split-th equal
part of the element's own valid range ``[start, length)``. A column is
(b, kv head, slice): the tensor-core kernel takes the whole group of G
heads in one block as ceil(G/16) row tiles of the MMA (``row_slices``
cuts only groups wider than 64); the CUDA-core kernel cuts more than 8 q
heads into ``head_slices`` of at most 8. With one split the block
writes the result itself; with more, the last block of each column to
finish, told by an integer ticket, combines the splits in split order
(the TPU kernel's own (acc, m, l) contract) and normalises, in the same
launch. ``launch_plan`` gives (slices, splits, warps) from the shapes
alone, so a CUDA graph replays a launch. Bound: bytes, the valid K/V
rows read once.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (check, library, multiprocessors,
                                        stream_handle)

FAMILY = "flash_decode"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: bytes of K/V a split is given at most, unless a wave of blocks would
#: leave the card short; and the fewest it is given
SPLIT_BYTES = 256 * 1024
MIN_SPLIT_BYTES = 64 * 1024
#: the most splits (the tensor-core kernel's combine keeps 2 floats a
#: split and head in shared memory)
MAX_SPLITS = 64
#: the tensor-core kernel takes 4 warps a block (one block a
#: multiprocessor) on a grid of at most this many blocks a
#: multiprocessor, 2 (three blocks a multiprocessor) on larger grids
FULL_BLOCKS_PER_SM = 1.25

#: the most q heads one block of the CUDA-core kernel holds (its running
#: state in registers)
SLICE_HEADS = 8
#: q heads a row tile of the tensor-core kernel (m16n8k16's rows), and
#: its most warps a block, each at most one row tile
TILE_HEADS = 16
MMA_WARPS = 4

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
         + [ctypes.c_float, ctypes.c_float, ctypes.c_int]
         + [ctypes.c_void_p] * 9)

#: the split tickets of each card: int32 zeros that every launch leaves
#: zero again (so calls on one stream at a time, as the port makes them)
_tickets = {}


def head_slices(G: int) -> int:
    """The CUDA-core kernel's fewest equal slices of a kv head's G q
    heads with at most ``SLICE_HEADS`` heads each (16 -> 2 of 8)."""
    n = -(-G // SLICE_HEADS)
    while G % n:
        n += 1
    return n


def row_tiles(G: int) -> int:
    """The tensor-core kernel's 16-row tiles of a kv head's G q heads."""
    return -(-G // TILE_HEADS)


def row_slices(G: int) -> int:
    """Blocks a kv head's row tiles take on the tensor-core kernel: one
    up to ``MMA_WARPS`` tiles (64 heads), a tile a warp."""
    return -(-row_tiles(G) // MMA_WARPS)


def mma_warps(blocks: int, G: int, sms: int) -> int:
    """Warps a block of the tensor-core kernel on a grid of ``blocks``: 4
    (one block a multiprocessor) where the grid holds at most
    ``FULL_BLOCKS_PER_SM`` blocks a multiprocessor, or where a block holds
    more than 2 row tiles; else 2, so that three blocks share a
    multiprocessor and one's prologue and epilogue hide behind the
    others' loads."""
    small = blocks <= FULL_BLOCKS_PER_SM * sms
    return MMA_WARPS if small or row_tiles(G) > 2 else 2


def plan_splits(columns: int, S: int, row_bytes: int, sms: int) -> int:
    """Slices of each element's valid range per column of blocks,
    ``columns`` of them, whose kv head's K and V take ``row_bytes`` a
    cache position: one per ``SPLIT_BYTES`` of a full cache, or, where
    that leaves the grid smaller than the card, as many as fill one wave
    of one block a multiprocessor (``sms // columns``: a column more
    would start a second wave for a few blocks); never a split under
    ``MIN_SPLIT_BYTES``, at most ``MAX_SPLITS``. A function of the shapes
    only, never of the lengths (which live on the card)."""
    nbytes = S * row_bytes
    want = max(-(-nbytes // SPLIT_BYTES), sms // max(columns, 1))
    return max(1, min(want, nbytes // MIN_SPLIT_BYTES, MAX_SPLITS))


def launch_plan(B: int, S: int, H: int, kvH: int, dh: int,
                dtype: torch.dtype, sms: int):
    """(slices, splits, warps) of a launch. bfloat16 at G >= 2 takes the
    tensor-core kernel: ``row_slices``, ``plan_splits``, ``mma_warps``.
    float32, and bfloat16 at G = 1 (where the MMA's rows would be 15/16
    empty), take the CUDA-core kernel: ``head_slices``, ``plan_splits``,
    warps 0 (its own 256 threads)."""
    G = H // kvH
    mma = dtype == torch.bfloat16 and G > 1
    slices = row_slices(G) if mma else head_slices(G)
    columns = B * kvH * slices
    n_split = plan_splits(columns, S, 2 * dh * dtype.itemsize, sms)
    warps = mma_warps(columns * n_split, G, sms) if mma else 0
    return slices, n_split, warps


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


def split_plan(B: int, S: int, H: int, kvH: int, dh: int,
               dtype: torch.dtype, device: torch.device) -> int:
    """The splits of a launch on the card ``device``."""
    return launch_plan(B, S, H, kvH, dh, dtype, multiprocessors(device))[1]


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
                        out: Optional[torch.Tensor] = None,
                        plan_batch: Optional[int] = None) -> None:
    """Enqueue the kernel, one launch, on the current stream.
    q (B,H,dh), k/v (B,S,kvH,dh), length/start (B,) int32, pre-checked
    by the wrapper. Writes the combined partials into ``acc``/``m``/``l``
    when given, and the normalised float32 output into ``out`` when
    given. The launch is planned for a batch of ``plan_batch`` (default
    B): the plan fixes each row's order of summation, so a call that must
    equal a larger one bit for bit passes that call's batch."""
    B, H, dh = q.shape
    S, kvH = k.shape[1], k.shape[2]
    slices, n_split, warps = launch_plan(plan_batch or B, S, H, kvH, dh,
                                         q.dtype, multiprocessors(q.device))
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
                 kvH, dh, slices, warps, float(scale), float(softcap),
                 n_split, ptr(part_acc), ptr(part_m), ptr(part_l),
                 ptr(tickets), ptr(acc), ptr(m), ptr(l), ptr(out),
                 stream_handle(q.device))
    check(FAMILY, "flash_decode", err)
