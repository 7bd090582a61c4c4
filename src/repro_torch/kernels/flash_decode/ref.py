"""Plain PyTorch version of the ``flash_decode`` kernel, and the
partials' ``finalize`` and ``combine``.

Returns UNNORMALIZED partials (acc, m, l), so results over pieces of a
cache combine (``combine``) into the result over the whole:
  acc = sum_s exp(s_s - m) v_s,   l = sum_s exp(s_s - m),
  m   = max_s s_s over the valid positions ``start <= s < length``,
with ``s_s = (q_f32 * scale) . k_s`` then ``tanh(s / softcap) *
softcap``. Masked scores are ``NEG_INF = -1e30`` and their p is 0, so
with no valid position m = -1e30, l = 0, acc = 0 and ``finalize``
gives 0. GQA: q head h reads kv head ``h // (H // kvH)``.

Like the TPU kernel (``repro/kernels/flash_decode/flash_decode.py``
``_kernel``), q and k are cast to float32 before q is scaled; the JAX
oracle (``ref.py`` there) scales and multiplies in q's dtype. The two
agree in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_decode_batched_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, length: torch.Tensor,
                             start: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None,
                             softcap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """q (B,H,dh); k/v (B,S,kvH,dh); length/start (B,) int32 ->
    (acc (B,H,dh), m (B,H), l (B,H)) float32."""
    B, H, dh = q.shape
    S, kvH = k.shape[1], k.shape[2]
    G = H // kvH
    scale = dh ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, kvH, G, dh) * scale
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < length.reshape(B, 1)
    if start is not None:
        valid &= pos[None, :] >= start.reshape(B, 1)
    valid = valid[:, None, None, :]                      # (B,1,1,S)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)                                   # (B,kvH,G)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return acc.reshape(B, H, dh), m.reshape(B, H), l.reshape(B, H)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, scale: Optional[float] = None,
                     softcap: float = 0.0,
                     start: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (H, dh); k/v (S, kvH, dh); length scalar = #valid positions;
    start scalar = first valid position (sliding window) ->
    (acc (H,dh), m (H,), l (H,))."""
    acc, m, l = flash_decode_batched_ref(
        q[None], k[None], v[None], length.reshape(1),
        None if start is None else start.reshape(1), scale, softcap)
    return acc[0], m[0], l[0]


def finalize(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    return acc / l.clamp(min=1e-30)[..., None]


def combine(parts):
    """Combine per-shard (acc, m, l) partials -> (acc, m, l) global."""
    accs, ms, ls = zip(*parts)
    m_g = torch.stack(ms).amax(dim=0)
    acc_g = sum(a * torch.exp(m - m_g)[..., None] for a, m in zip(accs, ms))
    l_g = sum(l * torch.exp(m - m_g) for l, m in zip(ls, ms))
    return acc_g, m_g, l_g
