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
float atomics, in two launches at every size: a counting sort by source
spread over thread block clusters (``plan_backward``: a tile of sources
a cluster, a slice of the dst rows a block, the (source, block) slots
scanned through distributed shared memory, each source's run placed in
edge order; the quotients g / max(count, 1) once a dst row; the zeros of
the rows no edge reads by TMA bulk stores), then the row sums over the
whole card in equal shares of the placed edges (``unit_share``, a row
cut by columns where shares meet: ``row_columns``), fed by TMA bulk
copies into a ring of shared buffers. Bound: bytes, the (m, d) output
plus g and the edge lists.
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
             + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
             + [ctypes.c_void_p])

#: the backward's plan: blocks a cluster of the order kernel, and the most
#: sources a tile (one block's shared histogram), as in gather_agg_bwd.cu
CLUSTER = 8
MAX_TILE_ROWS = 16384


def plan_backward(m: int, sms: int, clusters: int) -> Tuple[int, int, int,
                                                             int]:
    """(cluster, tiles, tile_rows, sum_blocks) of the backward for m >= 1
    rows of ``h`` on a card of ``sms`` multiprocessors that runs
    ``clusters`` order clusters at once: the sources are cut into equal
    tiles of at most ``MAX_TILE_ROWS``, one a cluster, as many as fill one
    wave (more only where m needs them); the sums take one block a
    multiprocessor."""
    tile_rows = min(MAX_TILE_ROWS, -(-m // max(1, min(clusters, m))))
    return CLUSTER, -(-m // tile_rows), tile_rows, sms


def slice_rows(nd: int, cluster: int, b: int) -> Tuple[int, int]:
    """The dst rows [lo, hi) whose edges block ``b`` of each order cluster
    counts and places: the b-th of ``cluster`` near-equal slices, whole
    rows in edge order."""
    return nd * b // cluster, nd * (b + 1) // cluster


def unit_share(units: int, blocks: int, j: int) -> Tuple[int, int]:
    """Sum block j's share [lo, hi) of the backward's units: the placed
    (unmasked) edges, in their by-source order."""
    return j * units // blocks, (j + 1) * units // blocks


def row_columns(u0: int, run: int, lo: int, hi: int,
                nv: int) -> Tuple[int, int]:
    """The vector columns [c0, c1) of a row of ``run`` placed edges from
    slot u0 that the share [lo, hi) sums: the row's nv columns cut in
    proportion to its edges, so that shares meeting inside a row take
    adjacent columns; none for a row no edge reads (the order kernel
    writes its zeros)."""
    a, b = max(u0, lo), min(u0 + run, hi)
    if a >= b:
        return 0, 0
    return (a - u0) * nv // run, (b - u0) * nv // run


_clusters: dict = {}


def active_clusters(device) -> int:
    """Order clusters the card runs at once (cached), as the occupancy
    calculator gives them for the order kernel's cluster, block and
    shared memory."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _clusters:
        fn = library(FAMILY).repro_gather_agg_bwd_clusters
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(CLUSTER, ctypes.byref(out))
        check(FAMILY, "gather_agg_bwd", err)
        if out.value < 1:
            raise RuntimeError(f"the card runs no cluster of {CLUSTER} "
                               f"gather_agg_bwd order blocks")
        _clusters[idx] = out.value
    return _clusters[idx]


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
    """Enqueue the order and sum kernels on the current stream; inputs
    pre-checked by the wrapper (m >= 1, d >= 1, nd < 2^24, fewer than
    2^31 edges, float32/int32/bool contiguous). Scratch, every entry
    written before it is read: the quotients g / max(count, 1) (rows
    padded to 16 bytes, for the sums' TMA copies), each placed edge's dst
    row, each row's first slot (m + 1) and each sum block's first row and
    that row's first slot."""
    m, d, dev = dh.shape[0], dh.shape[1], g.device
    n_edges = edge_src.shape[0]
    cluster, tiles, tile_rows, sum_blocks = plan_backward(
        m, multiprocessors(dev), active_clusters(dev))
    q = torch.empty((nd, -(-d // 4) * 4), dtype=torch.float32, device=dev)
    scratch = torch.empty(max(n_edges, 1) + m + 1 + 2 * sum_blocks,
                          dtype=torch.int32, device=dev)
    begin = scratch[max(n_edges, 1):]
    bounds = begin[m + 1:]
    fn = library(FAMILY).repro_gather_agg_bwd
    fn.argtypes = _BWD_ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(g.data_ptr(), d, edge_src.data_ptr(), edge_mask.data_ptr(),
                 nd, fanout, m, cluster, tiles, tile_rows, sum_blocks,
                 q.data_ptr(), scratch.data_ptr(), begin.data_ptr(),
                 bounds.data_ptr(), dh.data_ptr(), _vec(q, dh),
                 stream_handle(dev))
    check(FAMILY, "gather_agg_bwd", err)
