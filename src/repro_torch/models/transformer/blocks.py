"""Block-level init/apply for every layer kind: ``attn``/``local``,
``ssm`` and ``rglru``: the port's ``repro/models/transformer/blocks.py``.

Each block = mixer + (cross-attention in an enc-dec decoder) + (FFN |
MoE | nothing for ``ssm``), pre-norm residual (+ optional gemma2
sandwich post-norms); an MoE block may carry a dense FFN residual beside
its experts (arctic). Parameters for one *pattern position* are stacked
over the repeat dimension R in ``model.py``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.transformer.attention import (attention,
                                                      decode_attention)
from repro_torch.models.transformer.common import (ArchConfig, apply_mrope,
                                                   apply_rope, dense_init,
                                                   rms_norm)
from repro_torch.models.transformer.moe import init_moe_params, moe_apply
from repro_torch.models.transformer.rglru import (init_rglru_params,
                                                  rglru_decode_step,
                                                  rglru_forward)
from repro_torch.models.transformer.ssm import (init_ssm_params,
                                                ssm_decode_step,
                                                ssm_forward)
from repro_torch.serve.attention import sharded_decode_attention

ATTN_KINDS = ("attn", "local")
KINDS = ATTN_KINDS + ("ssm", "rglru")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


# --------------------------------------------------------------- init ----

def init_attn_params(cfg: ArchConfig, generator: torch.Generator, dtype,
                     device=None, cross: bool = False) -> Dict[str, Any]:
    """wq, wk, wv, wo; the qkv biases and q/k norms where the config has
    them, except for cross-attention, which has neither."""
    d = cfg.d_model
    p = {
        "wq": dense_init(generator, (d, cfg.q_dim), 0, dtype, device),
        "wk": dense_init(generator, (d, cfg.kv_dim), 0, dtype, device),
        "wv": dense_init(generator, (d, cfg.kv_dim), 0, dtype, device),
        "wo": dense_init(generator, (cfg.q_dim, d), 0, dtype, device),
    }
    zeros = dict(dtype=dtype, device=device or generator.device)
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((cfg.q_dim,), **zeros)
        p["bk"] = torch.zeros((cfg.kv_dim,), **zeros)
        p["bv"] = torch.zeros((cfg.kv_dim,), **zeros)
    if cfg.qk_norm and not cross:
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
                      device=None, with_cross: bool = False
                      ) -> Dict[str, Any]:
    """One block's parameters, drawn in order: the mixer, then the
    cross-attention (``with_cross``: ``ln_x`` and ``xattn``), then the
    experts, then the dense FFN. ``ssm`` blocks have no ``ln2``/FFN."""
    _check_kind(kind)
    d = cfg.d_model
    zeros = dict(dtype=dtype, device=device or generator.device)
    p: Dict[str, Any] = {"ln1": torch.zeros((d,), **zeros)}
    if kind in ATTN_KINDS:
        p["attn"] = init_attn_params(cfg, generator, dtype, device)
    elif kind == "ssm":
        p["ssm"] = init_ssm_params(cfg, generator, dtype, device)
    else:
        p["rglru"] = init_rglru_params(cfg, generator, dtype, device)
    if cfg.post_norms:
        p["ln1_post"] = torch.zeros((d,), **zeros)
    if with_cross:
        p["ln_x"] = torch.zeros((d,), **zeros)
        p["xattn"] = init_attn_params(cfg, generator, dtype, device,
                                      cross=True)
    if kind != "ssm":
        p["ln2"] = torch.zeros((d,), **zeros)
        if cfg.moe:
            p["moe"] = init_moe_params(cfg, generator, dtype, device)
        if not cfg.moe or cfg.dense_residual:
            p["ffn"] = init_ffn_params(cfg, generator, dtype, device)
        if cfg.post_norms:
            p["ln2_post"] = torch.zeros((d,), **zeros)
    return p


# -------------------------------------------------------------- apply ----

def _project_qkv(cfg: ArchConfig, p, h, positions, mrope_positions=None):
    """q, k, v (B, S, heads, dh) of h (B, S, d): bias and q/k norm where
    the params have them, then M-RoPE when the config has sections and
    streams (3, B, S) are given, else RoPE at ``positions``."""
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
    if cfg.mrope_sections and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta,
                        cfg.mrope_sections)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def ffn_apply(cfg: ArchConfig, p, h):
    act = cfg.activation()
    return (act(h @ p["w1"].to(h.dtype)) * (h @ p["w3"].to(h.dtype))
            ) @ p["w2"].to(h.dtype)


def mixer_ffn(cfg: ArchConfig, p, x, mesh=None):
    """The FFN/MoE half of a block (shared by the prefill and decode
    paths); the experts shard over ``mesh``'s ``model`` axis."""
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe:
        out = moe_apply(p["moe"], h2, cfg, mesh=mesh)
        if cfg.dense_residual:
            out = out + ffn_apply(cfg, p["ffn"], h2)
    else:
        out = ffn_apply(cfg, p["ffn"], h2)
    if cfg.post_norms:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    return x + out


def block_apply(cfg: ArchConfig, kind: str, p, x, *, positions=None,
                mrope_positions=None, enc_out=None, mesh=None,
                causal: bool = True):
    """Prefill forward for one block. x (B,S,d); ``causal=False`` for the
    encoder's self-attention. With ``enc_out`` (B, S_src, d) and the
    block's ``xattn``, the cross-attention sub-block runs after the
    mixer: q from x, k/v from ``enc_out`` (no bias, no RoPE), no mask.
    ``mesh`` shards the experts (``mixer_ffn``). The reference's
    ``cfg.seq_shard_attn`` only lays q's rows out over the ``model``
    axis for its compiler; attention computes the same values, so the
    port computes it as without the option."""
    _check_kind(kind)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        q, k, v = _project_qkv(cfg, p["attn"], h, positions, mrope_positions)
        window = cfg.window if kind == "local" else 0
        o = attention(q, k, v, causal=causal, window=window,
                      attn_softcap=cfg.attn_softcap,
                      q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
        o = o.reshape(*x.shape[:2], cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    elif kind == "ssm":
        o = ssm_forward(p["ssm"], h, cfg)
    else:
        o = rglru_forward(p["rglru"], h, cfg)
    if cfg.post_norms:
        o = rms_norm(o, p["ln1_post"], cfg.norm_eps)
    x = x + o
    if enc_out is not None and "xattn" in p:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        px = p["xattn"]
        B, S, _ = hx.shape
        q = (hx @ px["wq"].to(hx.dtype)).reshape(B, S, cfg.num_heads,
                                                 cfg.head_dim)
        k = (enc_out @ px["wk"].to(hx.dtype)).reshape(
            B, -1, cfg.num_kv_heads, cfg.head_dim)
        v = (enc_out @ px["wv"].to(hx.dtype)).reshape(
            B, -1, cfg.num_kv_heads, cfg.head_dim)
        o = attention(q, k, v, causal=False)
        x = x + o.reshape(B, S, cfg.q_dim) @ px["wo"].to(hx.dtype)
    return x if kind == "ssm" else mixer_ffn(cfg, p, x, mesh)


# -------------------------------------------------------- decode apply ----

def block_decode(cfg: ArchConfig, kind: str, p, x, state: Dict[str, Any],
                 *, pos, positions=None, mrope_positions=None, mesh=None,
                 window_override: int = 0):
    """One-token decode. x (B,1,d); state holds this block's caches --
    k/v (B, S_cache, kvH, dh) for attention, conv (B, K-1, C) and ssm
    (B, h, p, n) for ``ssm``, conv and h (B, w) for ``rglru`` -- which
    are written IN PLACE (the reference returns new arrays); the
    returned state holds the same tensors. pos (B,) int32 absolute
    position of the new token. Where the state holds the cross caches
    ``xk``/``xv`` (B, S_src, kvH, dh) and ``x_len`` (B,) int32 (written
    by the caller; read only here), the block's ``xattn`` attends over
    the first ``x_len`` rows of each; ``x_len = 0`` adds exactly 0, and so
    does a cache of no rows (``init_decode_state``'s default ``src_len=0``),
    which is skipped. With tp > 1 ``model`` shards in ``mesh`` the
    self-attention's cache is sequence-sharded over them
    (``sharded_decode_attention``, one kernel launch) and the experts are
    sharded (``mixer_ffn``); the cross-attention is not sharded.
    ``window_override``, as in the reference, is carried for the
    caller's sake: a sliding-window cache (``init_decode_state(...,
    window_override)``) is simply a smaller ring, which the write below
    wraps."""
    _check_kind(kind)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        q, k, v = _project_qkv(cfg, p["attn"], h, positions,
                               mrope_positions)
        k_cache, v_cache = state["k"], state["v"]
        S_cache = k_cache.shape[1]
        # ring-buffer write: when S_cache covers all positions this is the
        # identity; for window caches (S_cache == window) it wraps. RoPE
        # is applied at write time, so slot order is irrelevant to
        # attention (permutation-invariant over the valid set).
        slot = (pos % S_cache).long()
        bidx = torch.arange(x.shape[0], device=x.device)
        k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
        length = torch.clamp(pos + 1, max=S_cache).to(torch.int32)
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            o = sharded_decode_attention(mesh, q, k_cache, v_cache, length,
                                         attn_softcap=cfg.attn_softcap)
        else:
            o = decode_attention(q, k_cache, v_cache, length,
                                 attn_softcap=cfg.attn_softcap)
        o = o.reshape(x.shape[0], 1, cfg.q_dim) @ p["attn"]["wo"].to(
            x.dtype)
    elif kind == "ssm":
        o, new_conv, new_ssm = ssm_decode_step(p["ssm"], h, state["conv"],
                                               state["ssm"], cfg)
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(new_ssm)
    else:
        o, new_conv, new_h = rglru_decode_step(p["rglru"], h, state["conv"],
                                               state["h"], cfg)
        state["conv"].copy_(new_conv)
        state["h"].copy_(new_h)
    if cfg.post_norms:
        o = rms_norm(o, p["ln1_post"], cfg.norm_eps)
    x = x + o
    if "xattn" in p and "xk" in state and state["xk"].shape[1]:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        px = p["xattn"]
        B = hx.shape[0]
        q = (hx @ px["wq"].to(hx.dtype)).reshape(B, 1, cfg.num_heads,
                                                 cfg.head_dim)
        o = decode_attention(q, state["xk"], state["xv"], state["x_len"])
        x = x + o.reshape(B, 1, cfg.q_dim) @ px["wo"].to(hx.dtype)
    if kind != "ssm":
        x = mixer_ffn(cfg, p, x, mesh)
    return x, dict(state)
