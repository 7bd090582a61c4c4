"""Public wrappers of the ``flash_decode`` kernel: one element
(``flash_decode``, the (acc, m, l) partials) and a batch (its partials,
``flash_decode_partials``, and ``flash_decode_batched``, normalised), as
in ``repro/kernels/flash_decode/ops.py``.

Replaces the TPU kernel ``repro/kernels/flash_decode/flash_decode.py:67``:
one query token attends over a KV cache whose valid positions are
``start <= pos < length``, GQA (q head h reads kv head h // G), tanh
softcap after the scale, math in float32. The batch, which JAX vmaps, is
one launch here. Unlike the TPU kernel it takes any S. Bound on the
card: bytes, the valid K/V rows read once.

CPU tensors (or ``interpret=True``) take the plain version in
``ref.py``, and so do shape-only ``meta`` tensors (the dry-run's trace,
which computes nothing); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import LaunchCount, use_plain
from repro_torch.kernels.flash_decode.flash_decode import launch_flash_decode
from repro_torch.kernels.flash_decode.ref import (combine,
                                                  flash_decode_batched_ref,
                                                  finalize)

LAUNCHES = LaunchCount("flash_decode")

#: the widest head the kernel takes (any q-head group: bfloat16 takes up
#: to 64 in a block, float32 8)
MAX_HEAD_DIM = 256


def _lengths(t: Optional[torch.Tensor], B: int) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if t.dtype != torch.int32:
        raise ValueError(f"flash_decode: length/start must be int32, got "
                         f"{t.dtype}")
    return t.reshape(B).contiguous()


def _batched(q, k, v, length, start, scale, softcap, interpret, partials,
             plan_batch=None):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: expected q (B,H,dh) and k/v "
                         f"(B,S,kvH,dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, dh = q.shape
    S, kvH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or kvH == 0 or H % kvH or S < 1:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (S >= 1, H % kvH == 0)")
    length = _lengths(length, B)
    start = _lengths(start, B)
    scale = dh ** -0.5 if scale is None else scale
    tensors = [t for t in (q, k, v, length, start) if t is not None]
    # a shape-only trace (``meta``) computes nothing: the plain version
    if use_plain(interpret or q.device.type == "meta", *tensors):
        acc, m, l = flash_decode_batched_ref(q, k, v, length, start,
                                             scale=scale, softcap=softcap)
        return (acc, m, l) if partials else finalize(acc, l)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode kernel takes one dtype of "
                         f"float32/bfloat16, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode kernel takes head_dim a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}, got dh={dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and "
                             f"16-byte aligned")
    f32 = dict(dtype=torch.float32, device=q.device)
    if partials:
        acc = torch.empty((B, H, dh), **f32)
        m = torch.empty((B, H), **f32)
        l = torch.empty((B, H), **f32)
        launch_flash_decode(q, k, v, length, start, scale=scale,
                            softcap=softcap, acc=acc, m=m, l=l,
                            plan_batch=plan_batch)
        LAUNCHES.bump()
        return acc, m, l
    out = torch.empty((B, H, dh), **f32)
    launch_flash_decode(q, k, v, length, start, scale=scale, softcap=softcap,
                        out=out)
    LAUNCHES.bump()
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, start: Optional[torch.Tensor] = None,
                 *,
                 scale: Optional[float] = None, softcap: float = 0.0,
                 interpret: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (H, dh); k/v (S, kvH, dh); length/start int32 scalars ->
    float32 partials (acc (H, dh), m (H,), l (H,)); see ``ref.py``."""
    acc, m, l = _batched(q[None], k[None], v[None], length, start, scale,
                         softcap, interpret, partials=True)
    return acc[0], m[0], l[0]


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, length: torch.Tensor,
                          start: Optional[torch.Tensor] = None, *,
                          scale: Optional[float] = None,
                          softcap: float = 0.0, interpret: bool = False,
                          plan_batch: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """q (B, H, dh); k/v (B, S, kvH, dh); length/start (B,) int32 ->
    the float32 partials (acc (B, H, dh), m (B, H), l (B, H)) of each
    element, one launch (the sequence-sharded decode's shards).
    ``plan_batch``: the batch the card's launch is planned for (default
    B); a rank's shard passes the folded batch, so that its rows are
    summed as the folded launch sums them."""
    return _batched(q, k, v, length, start, scale, softcap, interpret,
                    partials=True, plan_batch=plan_batch)


def flash_decode_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor,
                         start: Optional[torch.Tensor] = None, *,
                         scale: Optional[float] = None, softcap: float = 0.0,
                         interpret: bool = False) -> torch.Tensor:
    """q (B, H, dh); k/v (B, S, kvH, dh); length/start (B,) int32 ->
    (B, H, dh) float32, ``finalize`` of the partials."""
    return _batched(q, k, v, length, start, scale, softcap, interpret,
                    partials=False)


__all__ = ["flash_decode", "flash_decode_partials", "flash_decode_batched",
           "finalize", "combine", "LAUNCHES"]
