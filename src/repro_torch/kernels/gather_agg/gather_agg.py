"""``ctypes`` bindings of the CUDA ``gather_agg`` kernels: the forward
(``csrc/gather_agg.cu``) and the backward (``csrc/gather_agg_bwd.cu``).

Replaces the TPU kernel ``repro/kernels/gather_agg/gather_agg.py``
``_kernel`` / ``gather_agg``. The TPU grid walks the fan-out axis in
order; here block (i, c) owns dst row i and 128 feature columns and each
thread loops over the fan-out in order, with no atomics. Bound: bytes,
the distinct source rows the unmasked edges reference plus the output.

The backward replaces the JAX custom VJP's ``segment_sum`` (``ops.py``
``_kernel_bwd``) with a by-source gather over edges sorted by the
``seg_sort`` kernel, a bounds pass for each row's run, and one block per
source row summing in edge order: deterministic, no atomics. Bound:
bytes, the (m, d) output plus g and the edge lists.
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


_BWD_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def launch_gather_agg_bwd(g: torch.Tensor, sorted_src: torch.Tensor,
                          sorted_edge: torch.Tensor, edge_mask: torch.Tensor,
                          nd: int, fanout: int, dh: torch.Tensor) -> None:
    """Enqueue the count, bounds and row-sum kernels on the current
    stream; inputs pre-checked by the wrapper (m >= 1, d >= 1,
    float32/int32/bool contiguous, edges sorted by source)."""
    m = dh.shape[0]
    cnt = torch.empty(nd, dtype=torch.float32, device=g.device)
    lo = torch.empty(m + 1, dtype=torch.int32, device=g.device)
    fn = library(FAMILY).repro_gather_agg_bwd
    fn.argtypes = _BWD_ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), g.shape[1], sorted_src.data_ptr(),
                 sorted_edge.data_ptr(), edge_mask.data_ptr(), nd, fanout,
                 cnt.data_ptr(), lo.data_ptr(), m, dh.data_ptr(),
                 stream_handle(g.device))
    check(FAMILY, "gather_agg_bwd", err)
