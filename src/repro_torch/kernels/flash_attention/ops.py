"""Public wrapper of the ``flash_attention`` kernel (prefill).

Replaces the TPU kernel ``repro/kernels/flash_attention/
flash_attention.py:76``: causal online-softmax attention forward with
GQA (q head h reads kv head h // G), an optional window
(``kpos > qpos - window``) and a tanh logit softcap applied after the
scale, all in float32, output in q's dtype. Unlike the TPU kernel it
takes any S (no tile-multiple assert), and k/v of their own length Skv
>= 1 when there is no mask (``causal=False``, no window): the
reference's cross-attention, which its chunked ``attention`` computes. bfloat16 inputs run on the tensor
cores with float32-grade arithmetic (exact bf16 products summed in
float32; p split into two bf16 terms for P.V), float32 inputs on the CUDA
cores. Bound on the card: operations, ``4 dh`` FLOP for each valid
(q head, key) pair (the causal triangle, or the window's band).

CPU tensors (or ``interpret=True``) take the plain version in
``ref.py``; CUDA tensors launch the kernel or raise. There is no
backward: a call that would need one raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCount, use_plain
from repro_torch.kernels.flash_attention.flash_attention import (
    launch_flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LAUNCHES = LaunchCount("flash_attention")

#: the widest head the kernel's tiles take
MAX_HEAD_DIM = 256


def _check(q, k, v, causal, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q/k/v must be 4-D (B,S,H,dh)")
    B, S, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Skv = k.shape[1]
    if Skv != S and (causal or window > 0 or Skv < 1):
        raise ValueError(f"flash_attention: k/v of length {Skv} != q's {S} "
                         f"only without a mask (causal=False, window=0) "
                         f"and Skv >= 1, got causal={causal} "
                         f"window={window}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} q heads over "
                         f"{k.shape[2]} kv heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    interpret: bool = False) -> torch.Tensor:
    """q (B,S,H,dh); k/v (B,Skv,kvH,dh) -> (B,S,H,dh) in q's dtype; Skv
    == S unless ``causal=False`` and ``window == 0``."""
    _check(q, k, v, causal, window)
    if use_plain(interpret, q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    dh = q.shape[3]
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes one dtype of "
                         f"float32/bfloat16, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, got {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward kernel: training takes the "
            "chunked attention of models/transformer/attention.py, which "
            "dispatches on requires_grad (a backward kernel is ROADMAP "
            "Queue 2 item 7)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = dh ** -0.5 if scale is None else scale
    launch_flash_attention(q, k, v, out, causal=causal, window=int(window),
                           softcap=float(softcap), scale=scale)
    LAUNCHES.bump()
    return out
