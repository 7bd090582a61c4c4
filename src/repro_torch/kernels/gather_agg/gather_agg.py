"""``ctypes`` bindings of the CUDA ``gather_agg`` kernels: the forward
(``csrc/gather_agg.cu``) and the backward (``csrc/gather_agg_bwd.cu``).

Replaces the TPU kernel ``repro/kernels/gather_agg/gather_agg.py``
``_kernel`` / ``gather_agg``. The TPU grid walks the fan-out axis in
order; here block (i, c) owns dst row i and 128 feature columns and each
thread loops over the fan-out in order, with no atomics. Bound: bytes,
the distinct source rows the unmasked edges reference plus the output.

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

import torch

from repro_torch.kernels._build import check, library, stream_handle

FAMILY = "gather_agg"

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def launch_gather_agg(h: torch.Tensor, edge_src: torch.Tensor,
                      edge_mask: torch.Tensor, nd: int, fanout: int,
                      out: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream; inputs pre-checked by
    the wrapper (nd >= 1, d >= 1, float32/int32/bool contiguous)."""
    fn = library(FAMILY).repro_gather_agg
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        err = fn(h.data_ptr(), h.shape[1], edge_src.data_ptr(),
                 edge_mask.data_ptr(), nd, fanout, out.data_ptr(),
                 stream_handle(h.device))
    check(FAMILY, "gather_agg", err)


_BWD_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_BWD_SORTED_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])

#: runs longer than this many edges are hub rows, summed by whole blocks
WARP_RUN = 16

_sms = {}


def _scratch(g: torch.Tensor, n_edges: int, m: int):
    """The kernels' scratch, all written before it is read: each placed
    edge's dst row (int32), count (float32) and source (int32), each row's
    first slot (m + 1 int32); and the card's multiprocessor count."""
    dev = g.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    n = max(n_edges, 1)
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(m + 1, dtype=torch.int32, device=dev), _sms[idx])


def _vec(g: torch.Tensor, dh: torch.Tensor) -> int:
    """The widest float vector (4, 2, 1) that d and both rows' addresses
    allow."""
    d = dh.shape[1]
    for w in (4, 2):
        if d % w == 0 and g.data_ptr() % (4 * w) == 0 \
                and dh.data_ptr() % (4 * w) == 0:
            return w
    return 1


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
