"""Mamba2 SSD (state-space duality) mixer [arXiv:2405.21060]: the port's
``repro/models/transformer/ssm.py``.

Chunked SSD (the paper's "minimal discrete" form): quadratic,
attention-like products INSIDE chunks of length Q, the recurrent state
passed BETWEEN chunks. The reference's ``lax.scan`` over chunks is a
Python loop over the S / Q chunks here (32 at S = 8192, Q = 256); each
of its three-operand einsums is written as two pairwise products, so no
six-index intermediate is ever formed. Decode is one recurrent state
update a token. Plain PyTorch: the reference has no Pallas kernel here.

``a_log``, ``dt_bias`` and ``D`` stay float32 in a bfloat16 model, as
the reference keeps them; the scan runs in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.common import (ArchConfig, dense_init,
                                                   rms_norm)


def init_ssm_params(cfg: ArchConfig, generator: torch.Generator, dtype,
                    device=None) -> Dict[str, torch.Tensor]:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dev = device or generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # in_proj packs [z (di), xBC (di+2n), dt (h)]
        "in_proj": dense_init(generator, (d, 2 * di + 2 * n + h), 0, dtype,
                              device),
        "conv_w": dense_init(generator, (cfg.ssm_conv, conv_dim), 0, dtype,
                             device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (di, d), 0, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d: x (B,S,C), w (K,C) -> (B,S,C), the taps
    summed in order as the reference does."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i] for i in range(K)) + b


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L): segsum[i, j] = sum_{t=j+1..i} a_t for
    i >= j (0 on the diagonal), -inf above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_scan(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x (b,S,h,p); dA (b,S,h); B,C (b,S,n) (single group).
    -> (y (b,S,h,p), final_state (b,h,p,n))."""
    b, S, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of the chunk "
                         f"{Q}")
    c = S // Q

    xc = x.reshape(b, c, Q, h, p)
    dAc = dA.reshape(b, c, Q, h)
    Bc = B.reshape(b, c, Q, n)
    Cc = C.reshape(b, c, Q, n)

    A_cs = torch.cumsum(dAc, dim=2)                         # (b,c,Q,h)
    L = torch.exp(_segsum(dAc.movedim(3, 2)))               # (b,c,h,Q,Q)

    # intra-chunk (diagonal blocks); exp(-inf) = 0 masks the upper
    # triangle. "bcqs,bchqs,bcshp->bcqhp" as (scores * L) @ x
    scores = Cc @ Bc.transpose(-1, -2)                      # (b,c,Q,Q)
    y_diag = (L * scores[:, :, None]) @ xc.permute(0, 1, 3, 2, 4)
    y_diag = y_diag.permute(0, 1, 3, 2, 4)                  # (b,c,Q,h,p)

    # per-chunk end states: "bcsn,bcsh,bcshp->bchpn" as (x * decay) @ B
    decay_to_end = torch.exp(A_cs[:, :, -1:, :] - A_cs)     # (b,c,Q,h)
    xd = xc * decay_to_end[..., None]                       # (b,c,Q,h,p)
    states = xd.permute(0, 1, 3, 4, 2) @ Bc[:, :, None]     # (b,c,h,p,n)

    # inter-chunk recurrence, chunk by chunk
    chunk_decay = torch.exp(A_cs[:, :, -1, :])              # (b,c,h)
    carry = init_state if init_state is not None else \
        torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    prevs = []
    for i in range(c):
        prevs.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prevs, dim=1)                 # (b,c,h,p,n)

    # the incoming state's part of each position:
    # "bcqn,bchpn,bcqh->bcqhp" as (C @ state^T) * exp(A_cs)
    y_off = Cc[:, :, None] @ prev_states.transpose(-1, -2)  # (b,c,h,Q,p)
    y_off = y_off.permute(0, 1, 3, 2, 4) * torch.exp(A_cs)[..., None]
    y = (y_diag + y_off).reshape(b, S, h, p)
    return y, carry


def _split_zxbcdt(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(zxbcdt, [di, di + 2 * n, cfg.ssm_heads], dim=-1)


def ssm_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """Full mamba2 mixer: x (B,S,d) -> (B,S,d)."""
    Bsz, S, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    z, xBC, dt = _split_zxbcdt(cfg, x @ params["in_proj"].to(x.dtype))
    xBC = F.silu(_causal_conv(xBC, params["conv_w"].to(x.dtype),
                              params["conv_b"].to(x.dtype)))
    xs, B_, C_ = torch.split(xBC, [di, n, n], dim=-1)
    xs = xs.reshape(Bsz, S, h, p)

    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["a_log"])                          # (h,)
    dA = dt * A                                              # (B,S,h)

    y, _ = ssd_scan(xs.float() * dt[..., None], dA, B_.float(), C_.float(),
                    cfg.ssm_chunk)
    y = y + params["D"][:, None] * xs.float()
    y = y.reshape(Bsz, S, di)
    y = rms_norm(y * F.silu(z.float()), params["norm_scale"], cfg.norm_eps)
    return (y @ params["out_proj"].to(y.dtype)).to(x.dtype)


def ssm_decode_step(params: Dict[str, torch.Tensor], x: torch.Tensor,
                    conv_state: torch.Tensor, ssm_state: torch.Tensor,
                    cfg: ArchConfig):
    """One-token decode. x (B,1,d); conv_state (B,K-1,conv_dim); ssm_state
    (B,h,p,n) float32 -> (y (B,1,d), new conv state, new ssm state), new
    tensors (``block_decode`` writes them into the caches)."""
    Bsz = x.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    z, xBC, dt = _split_zxbcdt(cfg, x[:, 0] @ params["in_proj"].to(x.dtype))
    conv_in = torch.cat([conv_state, xBC[:, None]], dim=1)   # (B,K,C)
    w = params["conv_w"].to(x.dtype)
    xBC = F.silu((conv_in * w).sum(dim=1) + params["conv_b"].to(x.dtype))
    new_conv = conv_in[:, 1:]

    xs, B_, C_ = torch.split(xBC, [di, n, n], dim=-1)
    xs = xs.reshape(Bsz, h, p).float()
    dt = F.softplus(dt.float() + params["dt_bias"])          # (B,h)
    A = -torch.exp(params["a_log"])
    da = torch.exp(dt * A)                                   # (B,h)

    # h_new = h * exp(dtA) + (dt*x) outer B
    upd = (xs * dt[..., None])[..., None] * B_.float()[:, None, None, :]
    new_ssm = ssm_state * da[..., None, None] + upd
    y = (new_ssm @ C_.float()[:, None, :, None])[..., 0]     # (B,h,p)
    y = y + params["D"][:, None] * xs
    y = y.reshape(Bsz, di)
    y = rms_norm(y * F.silu(z.float()), params["norm_scale"], cfg.norm_eps)
    out = (y @ params["out_proj"].to(y.dtype)).to(x.dtype)
    return out[:, None], new_conv, new_ssm
