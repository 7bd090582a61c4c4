"""Prefill and decode attention of the transformer substrate.

The port's ``repro/models/transformer/attention.py``. ``attention`` is
the reference's chunked online-softmax attention written out in PyTorch
(``_banded`` for sliding-window layers) on the CPU, and on the card
whenever a gradient is needed: the reference trains through that
algorithm, and the kernel has no backward. Otherwise a CUDA tensor goes
to the hand-written ``flash_attention`` kernel, one launch a call:
self-attention over one whole sequence (``Sq == Skv``, causal or not, a
window or not: the decoder and the encoder), and attention without a
mask between two lengths (``Sq != Skv``, ``causal=False``, no window:
cross-attention). Anything else (``q_offset != 0``, a causal or
windowed call with ``Sq != Skv``) raises.
``decode_attention`` is one ``flash_decode`` launch for the whole batch
on the card, its plain version on the CPU.

Tensors on the ``meta`` device (the dry-run's shape-only trace) take the
plain chunked route, which computes nothing there; an unmasked call runs
it as one chunk, the same matmuls in one iteration. Every other device
but ``cpu`` and ``cuda`` raises.

One difference in bfloat16: this chunked version, like the reference,
scales q in its input dtype before the float32 cast; the kernel (like
the Pallas kernel it replaces) casts first and then scales. They agree
in float32.

GQA is computed in grouped form: q is reshaped to (B, S, kvH, G, dh) and
k/v are never repeated to H heads.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode_batched
from repro_torch.models.transformer.common import softcap as _softcap

NEG_INF = -1e30


def _online_update(carry, s, v_chunk, valid):
    m, l, acc = carry
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = (acc * alpha[..., None]
               + torch.einsum("bhgqk,bkhd->bhgqd", p, v_chunk))
    return m_new, l_new, acc_new


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              attn_softcap: float = 0.0, q_chunk: int = 512,
              kv_chunk: int = 1024, scale: Optional[float] = None,
              q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,H,dh); k/v (B,Skv,kvH,dh) -> (B,Sq,H,dh).

    ``q_offset`` is the absolute position of q[0] (cross-chunk prefill).
    ``window > 0`` restricts attention to the last `window` positions
    (inclusive of self) and switches to banded compute on the chunked
    path. The chunked path runs when any of q/k/v needs a gradient.
    """
    B, Sq, H, dh = q.shape
    _, Skv, kvH, _ = k.shape
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if q.device.type == "cuda" and not needs_grad:
        if q_offset != 0:
            raise NotImplementedError(
                "attention on the card: cross-chunk prefill (q_offset != 0) "
                "is not a path of the port; the flash_attention kernel "
                "takes a whole sequence")
        if Sq != Skv and (causal or window > 0):
            raise NotImplementedError(
                f"attention on the card: a causal or windowed call with "
                f"Sq={Sq} != Skv={Skv} has no diagonal in the reference; "
                f"the flash_attention kernel takes Sq != Skv only without "
                f"a mask (cross-attention, causal=False, window=0)")
        # a window is always causal, as the reference's ``_banded`` and
        # the CPU path below are, whatever ``causal`` says
        return flash_attention(q, k, v, causal=causal or window > 0,
                               window=window, softcap=attn_softcap,
                               scale=scale)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no attention path for device {q.device}")
    if q.device.type == "meta" and window == 0:
        # shape-only: the unmasked chunked loop does the same products
        # whatever its chunks (every block is computed), so one chunk
        # traces the same matmul FLOPs in one iteration
        q_chunk, kv_chunk = Sq, Skv
    dev = q.device
    G = H // kvH
    scale = scale if scale is not None else dh ** -0.5
    qg = (q * scale).reshape(B, Sq, kvH, G, dh)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"chunked attention needs Sq % q_chunk == 0 and "
                         f"Skv % kv_chunk == 0, got {Sq}/{q_chunk}, "
                         f"{Skv}/{kv_chunk}")

    if window > 0:
        return _banded(qg, k, v, window=window, attn_softcap=attn_softcap,
                       q_chunk=q_chunk, q_offset=q_offset).reshape(
                           B, Sq, H, dh)

    nq, nk = Sq // q_chunk, Skv // kv_chunk
    blocks = []
    for i in range(nq):
        qb = qg[:, i * q_chunk:(i + 1) * q_chunk].permute(0, 2, 3, 1, 4)
        qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        carry = (torch.full((B, kvH, G, q_chunk), NEG_INF, device=dev),
                 torch.zeros((B, kvH, G, q_chunk), device=dev),
                 torch.zeros((B, kvH, G, q_chunk, dh), device=dev))
        for j in range(nk):
            kb = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            vb = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            s = torch.einsum("bhgqd,bkhd->bhgqk", qb.float(), kb.float())
            s = _softcap(s, attn_softcap)
            kpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            valid = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                               device=dev)
            if causal:
                valid = kpos[None, :] <= qpos[:, None]
            carry = _online_update(carry, s, vb.float(), valid)
        m, l, acc = carry
        out = acc / l.clamp(min=1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4))          # (B,Tq,kvH,G,dh)
    out = torch.cat(blocks, dim=1)
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _banded(qg, k, v, *, window, attn_softcap, q_chunk, q_offset):
    """Sliding-window attention over a sliced KV band."""
    B, Sq, kvH, G, dh = qg.shape
    Skv = k.shape[1]
    dev = qg.device
    band = min(window + q_chunk, Skv)  # covers all positions a chunk needs
    nq = Sq // q_chunk
    blocks = []
    for i in range(nq):
        qb = qg[:, i * q_chunk:(i + 1) * q_chunk].permute(0, 2, 3, 1, 4)
        qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        start = min(max(q_offset + i * q_chunk + q_chunk - band, 0),
                    Skv - band)
        kb = k[:, start:start + band]
        vb = v[:, start:start + band]
        s = torch.einsum("bhgqd,bkhd->bhgqk", qb.float(), kb.float())
        s = _softcap(s, attn_softcap)
        kpos = start + torch.arange(band, device=dev)
        valid = ((kpos[None, :] <= qpos[:, None])
                 & (kpos[None, :] > qpos[:, None] - window))
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        out = torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
        out = out / p.sum(-1).clamp(min=1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4))          # (B,Tq,kvH,G,dh)
    out = torch.cat(blocks, dim=1)
    return out.to(k.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor, *,
                     window: int = 0, attn_softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode: q (B,1,H,dh); caches (B,S,kvH,dh); length (B,)
    int32. One ``flash_decode`` launch for the batch (the reference vmaps
    its per-element call)."""
    if window > 0:
        start = (length - window).clamp(min=0)
    else:
        start = torch.zeros_like(length)
    out = flash_decode_batched(q[:, 0].contiguous(), k_cache, v_cache,
                               length, start, scale=scale,
                               softcap=attn_softcap)
    return out[:, None].to(q.dtype)
