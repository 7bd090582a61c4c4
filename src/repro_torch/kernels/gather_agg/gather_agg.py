"""``ctypes`` bindings of the CUDA ``gather_agg`` kernels: the forward
(``csrc/gather_agg.cu``) and the backward (``csrc/gather_agg_bwd.cu``).

Replaces the TPU kernel ``repro/kernels/gather_agg/gather_agg.py``
``_kernel`` / ``gather_agg``. The TPU grid walks the fan-out axis in
order; here a warp owns a dst row (or, where the rows alone would leave
the card under-filled, a slice of its columns: ``plan_forward``), loads
the row's edge ids and mask bytes once, and sums the unmasked edges'
rows in edge order as float4, float2 or float vectors, a few edges' row
loads in flight ahead of their adds; one launch, no atomics. Bound:
bytes, the distinct source rows the unmasked edges reference plus the
output and the edge lists.

The backward replaces the JAX custom VJP's ``segment_sum`` (``ops.py``
``_kernel_bwd``) with a by-source gather, deterministic and free of
float atomics, in two launches for up to 16,384 edges: one block lays
out each row's edges (a counting sort by source in shared memory) while
the card's other blocks sum the hub rows (more than 16 edges); then
warps sort each remaining row's edges by dst row and sum them in that
order, and write the empty rows as zeros. Larger edge lists are sorted
by the ``seg_sort`` kernel first. Bound: bytes, the (m, d) output plus g
and the edge lists.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import (check, library, multiprocessors,
                                        stream_handle)

FAMILY = "gather_agg"

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2

#: the forward's plan: resident warps it aims for on each multiprocessor,
#: the most vectors a lane owns in one column pass (``kMaxChunks``) and the
#: row loads a lane keeps in flight (``kInFlight``), as in gather_agg.cu
WARPS_PER_SM = 16
MAX_CHUNKS = 8
IN_FLIGHT = 16


def plan_forward(nd: int, d: int, vec: int, sms: int) -> Tuple[int, int,
                                                               int]:
    """(splits, chunks, unroll) of the forward: ``splits`` warps share a
    dst row's ``d // vec`` vectors, in equal slices of at least 32 (one a
    lane), only where ``nd`` warps alone would leave the ``sms``
    multiprocessors short of ``WARPS_PER_SM`` each; a lane owns ``chunks``
    vectors 32 apart in a column pass, the slice taken in as few passes
    as ``MAX_CHUNKS`` allows; ``unroll`` edges' row loads are issued
    before their adds."""
    nvec = d // vec
    want = -(-sms * WARPS_PER_SM // max(nd, 1))
    splits = max(1, min(want, nvec // 32))
    width = -(-nvec // splits)
    passes = -(-width // (32 * MAX_CHUNKS))
    chunks = -(-width // (32 * passes))
    return splits, chunks, max(1, IN_FLIGHT // chunks)


def launch_gather_agg(h: torch.Tensor, edge_src: torch.Tensor,
                      edge_mask: torch.Tensor, nd: int, fanout: int,
                      out: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream; inputs pre-checked by
    the wrapper (nd >= 1, d >= 1, float32/int32/bool contiguous)."""
    vec = _vec(h, out)
    splits, chunks, _ = plan_forward(nd, h.shape[1], vec,
                                     multiprocessors(h.device))
    fn = library(FAMILY).repro_gather_agg
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        err = fn(h.data_ptr(), h.shape[1], edge_src.data_ptr(),
                 edge_mask.data_ptr(), nd, fanout, vec, splits, chunks,
                 out.data_ptr(), stream_handle(h.device))
    check(FAMILY, "gather_agg", err)


_BWD_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_BWD_SORTED_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])

#: runs longer than this many edges are hub rows, summed by whole blocks
WARP_RUN = 16


def _scratch(g: torch.Tensor, n_edges: int, m: int):
    """The kernels' scratch, all written before it is read: each placed
    edge's dst row (int32), count (float32) and source (int32), each row's
    first slot (m + 1 int32); and the card's multiprocessor count."""
    dev = g.device
    n = max(n_edges, 1)
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(m + 1, dtype=torch.int32, device=dev),
            multiprocessors(dev))


def vec_width(d: int, *addresses: int) -> int:
    """The widest float vector (4, 2, 1) that d and every row's start
    address allow."""
    for w in (4, 2):
        if d % w == 0 and all(a % (4 * w) == 0 for a in addresses):
            return w
    return 1


def _vec(a: torch.Tensor, b: torch.Tensor) -> int:
    return vec_width(b.shape[1], a.data_ptr(), b.data_ptr())


def launch_gather_agg_bwd(g: torch.Tensor, edge_src: torch.Tensor,
                          edge_mask: torch.Tensor, nd: int, fanout: int,
                          dh: torch.Tensor) -> None:
    """Enqueue the order and row-sum kernels (the one-block route) on the
    current stream; inputs pre-checked by the wrapper (m >= 1, d >= 1,
    float32/int32/bool contiguous, ``ops.one_block`` true)."""
    m = dh.shape[0]
    ord_i, ord_c, ord_s, begin, sms = _scratch(g, nd * fanout, m)
    fn = library(FAMILY).repro_gather_agg_bwd
    fn.argtypes = _BWD_ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), g.shape[1], edge_src.data_ptr(),
                 edge_mask.data_ptr(), nd, fanout, m, ord_i.data_ptr(),
                 ord_c.data_ptr(), ord_s.data_ptr(), begin.data_ptr(),
                 dh.data_ptr(), _vec(g, dh), sms, stream_handle(g.device))
    check(FAMILY, "gather_agg_bwd", err)


def launch_gather_agg_bwd_sorted(g: torch.Tensor, sorted_src: torch.Tensor,
                                 sorted_edge: torch.Tensor,
                                 edge_mask: torch.Tensor, nd: int,
                                 fanout: int, dh: torch.Tensor) -> None:
    """Enqueue the run, hub-row and row-sum kernels (the ``seg_sort``
    route) on the current stream; edges already sorted by source."""
    m = dh.shape[0]
    n_edges = nd * fanout
    ord_i, ord_c, ord_s, begin, sms = _scratch(g, n_edges, m)
    hubs = torch.empty(n_edges // (WARP_RUN + 1) + 2, dtype=torch.int32,
                       device=g.device)
    fn = library(FAMILY).repro_gather_agg_bwd_sorted
    fn.argtypes = _BWD_SORTED_ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), g.shape[1], sorted_src.data_ptr(),
                 sorted_edge.data_ptr(), edge_mask.data_ptr(), nd, fanout, m,
                 ord_i.data_ptr(), ord_c.data_ptr(), ord_s.data_ptr(),
                 begin.data_ptr(), hubs.data_ptr(), hubs[1:].data_ptr(),
                 dh.data_ptr(), _vec(g, dh), sms, stream_handle(g.device))
    check(FAMILY, "gather_agg_bwd", err)
