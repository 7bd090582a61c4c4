"""Block-level init/apply for the dense attention kinds (``attn`` and
``local``): the port's ``repro/models/transformer/blocks.py``.

Each block = attention mixer + FFN, pre-norm residual (+ optional gemma2
sandwich post-norms). Parameters for one *pattern position* are stacked
over the repeat dimension R in ``model.py``. The ``ssm`` and ``rglru``
kinds raise until they are ported (ROADMAP Queue 1 item 3); so do the
config options no ported config sets (``model.check_supported``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.transformer.attention import (attention,
                                                      decode_attention)
from repro_torch.models.transformer.common import (ArchConfig, apply_rope,
                                                   dense_init, rms_norm)

ATTN_KINDS = ("attn", "local")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue 1 item 3")


def _check_kind(kind: str) -> None:
    if kind in ("ssm", "rglru"):
        raise not_ported(f"the {kind!r} block")
    if kind not in ATTN_KINDS:
        raise ValueError(kind)


# --------------------------------------------------------------- init ----

def init_attn_params(cfg: ArchConfig, generator: torch.Generator, dtype,
                     device=None) -> Dict[str, Any]:
    d = cfg.d_model
    p = {
        "wq": dense_init(generator, (d, cfg.q_dim), 0, dtype, device),
        "wk": dense_init(generator, (d, cfg.kv_dim), 0, dtype, device),
        "wv": dense_init(generator, (d, cfg.kv_dim), 0, dtype, device),
        "wo": dense_init(generator, (cfg.q_dim, d), 0, dtype, device),
    }
    zeros = dict(dtype=dtype, device=device or generator.device)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), **zeros)
        p["bk"] = torch.zeros((cfg.kv_dim,), **zeros)
        p["bv"] = torch.zeros((cfg.kv_dim,), **zeros)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((cfg.head_dim,), **zeros)
        p["k_norm"] = torch.zeros((cfg.head_dim,), **zeros)
    return p


def init_ffn_params(cfg: ArchConfig, generator: torch.Generator, dtype,
                    device=None) -> Dict[str, Any]:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": dense_init(generator, (d, ff), 0, dtype, device),
            "w3": dense_init(generator, (d, ff), 0, dtype, device),
            "w2": dense_init(generator, (ff, d), 0, dtype, device)}


def init_block_params(cfg: ArchConfig, kind: str,
                      generator: torch.Generator, dtype,
                      device=None) -> Dict[str, Any]:
    _check_kind(kind)
    d = cfg.d_model
    zeros = dict(dtype=dtype, device=device or generator.device)
    p: Dict[str, Any] = {"ln1": torch.zeros((d,), **zeros)}
    p["attn"] = init_attn_params(cfg, generator, dtype, device)
    if cfg.post_norms:
        p["ln1_post"] = torch.zeros((d,), **zeros)
    p["ln2"] = torch.zeros((d,), **zeros)
    p["ffn"] = init_ffn_params(cfg, generator, dtype, device)
    if cfg.post_norms:
        p["ln2_post"] = torch.zeros((d,), **zeros)
    return p


# -------------------------------------------------------------- apply ----

def _project_qkv(cfg: ArchConfig, p, h, positions):
    B, S, _ = h.shape
    q = h @ p["wq"].to(h.dtype)
    k = h @ p["wk"].to(h.dtype)
    v = h @ p["wv"].to(h.dtype)
    if "bq" in p:
        q, k, v = (q + p["bq"].to(h.dtype), k + p["bk"].to(h.dtype),
                   v + p["bv"].to(h.dtype))
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def ffn_apply(cfg: ArchConfig, p, h):
    act = cfg.activation()
    return (act(h @ p["w1"].to(h.dtype)) * (h @ p["w3"].to(h.dtype))
            ) @ p["w2"].to(h.dtype)


def mixer_ffn(cfg: ArchConfig, p, x):
    """The FFN half of a block (shared by the prefill and decode paths)."""
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    out = ffn_apply(cfg, p["ffn"], h2)
    if cfg.post_norms:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    return x + out


def block_apply(cfg: ArchConfig, kind: str, p, x, *, positions=None):
    """Prefill forward for one block. x (B,S,d)."""
    _check_kind(kind)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p["attn"], h, positions)
    window = cfg.window if kind == "local" else 0
    o = attention(q, k, v, window=window,
                  attn_softcap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk,
                  kv_chunk=cfg.attn_kv_chunk)
    o = o.reshape(*x.shape[:2], cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    if cfg.post_norms:
        o = rms_norm(o, p["ln1_post"], cfg.norm_eps)
    x = x + o
    return mixer_ffn(cfg, p, x)


# -------------------------------------------------------- decode apply ----

def block_decode(cfg: ArchConfig, kind: str, p, x, state: Dict[str, Any],
                 *, pos, positions=None):
    """One-token decode. x (B,1,d); state holds this block's caches
    (k/v (B, S_cache, kvH, dh)), which are written IN PLACE (the
    reference returns new arrays); the returned state holds the same
    tensors. pos (B,) int32 absolute position of the new token."""
    _check_kind(kind)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p["attn"], h, positions)
    k_cache, v_cache = state["k"], state["v"]
    S_cache = k_cache.shape[1]
    # ring-buffer write: when S_cache covers all positions this is the
    # identity; for window caches (S_cache == window) it wraps. RoPE is
    # applied at write time, so slot order is irrelevant to attention
    # (permutation-invariant over the valid set).
    slot = (pos % S_cache).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    length = torch.clamp(pos + 1, max=S_cache).to(torch.int32)
    o = decode_attention(q, k_cache, v_cache, length,
                         attn_softcap=cfg.attn_softcap)
    o = o.reshape(x.shape[0], 1, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    if cfg.post_norms:
        o = rms_norm(o, p["ln1_post"], cfg.norm_eps)
    x = x + o
    return mixer_ffn(cfg, p, x), dict(state)
