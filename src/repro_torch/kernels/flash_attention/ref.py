"""Plain PyTorch version of the ``flash_attention`` kernel.

The same function as the TPU kernel ``repro/kernels/flash_attention/
flash_attention.py`` ``_kernel``: for query position i of head
``kvh * G + g`` (consecutive q heads share kv head ``kvh = h // G``),
keys j with ``j <= i`` (causal) and ``j > i - window`` (window > 0) are
valid; ``s = (q_f32 * scale) . k_f32``, then ``tanh(s / softcap) *
softcap``; masked scores are ``NEG_INF = -1e30`` and their ``p`` is 0;
the output is ``sum p v / max(sum p, 1e-30)`` in q's dtype. A row with no
valid key gives 0. k/v may have a length Skv of their own (keys
``0 <= j < Skv``); the wrapper allows it only without a mask.

Where the scale is applied: like the Pallas kernel (and the CUDA kernel
here), q is cast to float32 first and scaled after. The JAX substrate's
``attention`` (``repro/models/transformer/attention.py``, and the
port's CPU path in ``models/transformer/attention.py``) scales q in its
input dtype before the cast. The two agree in float32 and differ by
q's rounding in bfloat16.

One softmax pass per block of query rows over all keys, not an online
one: the same function, with the sums in another order.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: Optional[float] = None,
                        q_block: int = 1024) -> torch.Tensor:
    """q (B,S,H,dh); k/v (B,Skv,kvH,dh) -> (B,S,H,dh) in q's dtype."""
    B, S, H, dh = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    scale = dh ** -0.5 if scale is None else scale
    kf = k.float().permute(0, 2, 1, 3)                  # (B,kvH,Skv,dh)
    vf = v.float().permute(0, 2, 1, 3)
    kpos = torch.arange(Skv, device=q.device)
    out = torch.empty_like(q)
    for lo in range(0, S, q_block):
        hi = min(S, lo + q_block)
        qb = q[:, lo:hi].float().reshape(B, hi - lo, kvH, G, dh) \
            .permute(0, 2, 3, 1, 4)                     # (B,kvH,G,Tq,dh)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb * scale, kf)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        qpos = torch.arange(lo, hi, device=q.device)
        valid = torch.ones((hi - lo, Skv), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            valid &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf) / l.clamp(min=1e-30)
        out[:, lo:hi] = o.permute(0, 3, 1, 2, 4).reshape(
            B, hi - lo, H, dh).to(q.dtype)
    return out
