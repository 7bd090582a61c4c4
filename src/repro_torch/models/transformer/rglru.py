"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427]:
the port's ``repro/models/transformer/rglru.py``.

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_r u_t + b_r)           (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)           (input gate)
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The reference runs the linear recurrence as ``jax.lax.associative_scan``
over (a, b) pairs. PyTorch has no such primitive, so the port runs a
log-depth (Hillis-Steele) scan over the same pairs in plain PyTorch:
ceil(log2 S) doubling steps over the whole sequence (13 at S = 8192), a
few elementwise launches each, where a per-token loop would take some
three launches a token. It associates the products in another order
than XLA's tree. Decode is an O(1) state update. The Griffin recurrent
block wraps the RG-LRU with a temporal conv and a GeLU gate branch.

``b_r``, ``b_i`` and ``lam`` stay float32 in a bfloat16 model, as the
reference keeps them; the gates and the scan run in float32.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.common import ArchConfig, dense_init
from repro_torch.models.transformer.ssm import _causal_conv

_C = 8.0

#: ``jax.nn.gelu``'s default, which the reference's gate branch uses
_gelu = functools.partial(F.gelu, approximate="tanh")


def init_rglru_params(cfg: ArchConfig, generator: torch.Generator, dtype,
                      device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    w = cfg.lru_width or d
    nb = max(cfg.num_heads, 1)         # gate blocks (Griffin §2.4)
    if w % nb:
        raise ValueError(f"lru_width {w} is not a multiple of the "
                         f"{nb} gate blocks")
    wb = w // nb
    dev = device or generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_x": dense_init(generator, (d, w), 0, dtype, device),
        "w_gate": dense_init(generator, (d, w), 0, dtype, device),
        "w_out": dense_init(generator, (w, d), 0, dtype, device),
        "conv_w": dense_init(generator, (cfg.ssm_conv, w), 0, dtype, device),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        # block-diagonal recurrence/input gates (head-local)
        "w_r": dense_init(generator, (nb, wb, wb), 1, dtype, device),
        "b_r": torch.zeros((w,), **f32),
        "w_i": dense_init(generator, (nb, wb, wb), 1, dtype, device),
        "b_i": torch.zeros((w,), **f32),
        # Lambda such that a^c ~ U[0.9, 0.999] at r=1 (the paper's init)
        "lam": torch.log(torch.expm1(-torch.log(
            torch.linspace(0.9, 0.999, w, **f32)) / _C)),
    }


def _block_mm(u: torch.Tensor, wblk: torch.Tensor) -> torch.Tensor:
    """u (..., w) x block-diagonal (nb, wb, wb) -> (..., w), head-local."""
    nb, wb, _ = wblk.shape
    ub = u.reshape(*u.shape[:-1], nb, wb)
    out = torch.einsum("...hw,hwv->...hv", ub, wblk.to(u.dtype))
    return out.reshape(u.shape)


def _gates(params, u: torch.Tensor):
    r = torch.sigmoid(_block_mm(u, params["w_r"])
                      + params["b_r"].to(u.dtype))
    i = torch.sigmoid(_block_mm(u, params["w_i"])
                      + params["b_i"].to(u.dtype))
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-9, 1.0)) \
        * (i * u)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1,
    in ceil(log2 S) doubling steps: after the step of stride d each
    position holds the composition of the (up to 2d) pairs ending there,
    ``(a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2)``, the reference's
    ``combine``. -> (the products of a, h)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def rglru_scan(params: Dict[str, torch.Tensor], u: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B,S,w) float32 -> (h (B,S,w), final state (B,w))."""
    a, b = _gates(params, u)
    if h0 is not None:
        # fold the carried state into the first step's offset
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, h = linear_scan(a, b)
    return h, h[:, -1]


def rglru_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """Griffin recurrent block: x (B,S,d) -> (B,S,d)."""
    u = x @ params["w_x"].to(x.dtype)
    u = _causal_conv(u, params["conv_w"].to(x.dtype),
                     params["conv_b"].to(x.dtype))
    h, _ = rglru_scan(params, u.float())
    g = _gelu(x @ params["w_gate"].to(x.dtype))
    return (h.to(x.dtype) * g) @ params["w_out"].to(x.dtype)


def rglru_decode_step(params: Dict[str, torch.Tensor], x: torch.Tensor,
                      conv_state: torch.Tensor, h_state: torch.Tensor,
                      cfg: ArchConfig):
    """x (B,1,d); conv_state (B,K-1,w); h_state (B,w) float32 -> (y
    (B,1,d), new conv state, new h), new tensors (``block_decode``
    writes them into the caches)."""
    u = x[:, 0] @ params["w_x"].to(x.dtype)                  # (B,w)
    conv_in = torch.cat([conv_state, u[:, None]], dim=1)
    w = params["conv_w"].to(x.dtype)
    u = (conv_in * w).sum(dim=1) + params["conv_b"].to(x.dtype)
    new_conv = conv_in[:, 1:]

    a, b = _gates(params, u.float())
    h_new = a * h_state + b
    g = _gelu(x[:, 0] @ params["w_gate"].to(x.dtype))
    out = (h_new.to(x.dtype) * g) @ params["w_out"].to(x.dtype)
    return out[:, None], new_conv, h_new
