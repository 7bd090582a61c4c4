"""Model assembly: the decoder-only LM's prefill (``forward``) and decode
(``init_decode_state``, ``serve_step``): the port's
``repro/models/transformer/model.py``.

The parameter tree has the reference's layout: ``embed``,
``final_norm``, ``lm_head`` when embeddings are untied, ``blocks`` (one
dict per pattern position, every leaf stacked over the repeat dimension
R) and ``tail_blocks``. Where the reference scans over R, the port loops
in Python, applying the pattern positions in the same order inside each
repeat. The LM loss and train step, the encoder and the enc-dec, MoE,
SSM, RG-LRU and M-RoPE paths wait for ROADMAP Queue 1 item 12; a config
that needs one raises (``check_supported``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.transformer.blocks import (block_apply,
                                                   block_decode,
                                                   init_block_params,
                                                   not_ported)
from repro_torch.models.transformer.common import (ArchConfig, dense_init,
                                                   rms_norm)


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what the port's transformer does not run yet."""
    for flag, what in ((cfg.kind == "encdec", "the enc-dec model"),
                       (cfg.moe, "MoE"), (cfg.mrope_sections, "M-RoPE"),
                       (cfg.frontend, f"the {cfg.frontend!r} frontend"),
                       (cfg.qkv_bias, "qkv bias"),
                       (cfg.qk_norm, "per-head q/k norm")):
        if flag:
            raise not_ported(what)
    for kind in cfg.pattern + cfg.tail:
        if kind not in ("attn", "local"):
            raise not_ported(f"the {kind!r} block")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def block_params(params, i: int, r: int):
    """The parameters of pattern position ``i`` in repeat ``r``."""
    return _map(lambda a: a[r], params["blocks"][i])


# ------------------------------------------------------------- init ------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Parameters with the reference's layout and init law (normal draws
    with std ``fan_in ** -0.5`` in float32, cast to the config's dtype;
    norms zero), drawn from ``generator`` on its own device and placed
    on ``device`` (default: the generator's). The draws differ from
    ``jax.random``'s; ``params_from_numpy`` carries the reference's."""
    check_supported(cfg)
    dt = _dtype(cfg)
    device = torch.device(device) if device is not None else \
        generator.device
    params: Dict[str, Any] = {
        "embed": dense_init(generator, (cfg.padded_vocab, cfg.d_model), 1,
                            dt, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), 0, dt, device)
    R = cfg.num_repeats
    params["blocks"] = [
        _stack([init_block_params(cfg, kind, generator, dt, device)
                for _ in range(R)])
        for kind in cfg.pattern]
    params["tail_blocks"] = [
        init_block_params(cfg, kind, generator, dt, device)
        for kind in cfg.tail]
    return params


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (the reference's ``init_params`` output moved
    through ``np.asarray``) -> the same tree of tensors on ``device``."""
    return _map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


# ---------------------------------------------------------- forward ------

def _embed(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    dt = _dtype(cfg)
    x = params["embed"][tokens.long()].to(dt)
    if cfg.embed_scale:
        # sqrt(d) rounded to the model's dtype, as the reference does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float64
                             ).to(dt).to(x.device)
    return x


def _logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm, tied (or separate) head, slice to the vocabulary,
    float32, final softcap (in place, to hold one float32 copy of the
    logits)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(_dtype(cfg))
    logits = (x @ head)[..., :cfg.vocab_size].float()
    if cfg.final_softcap > 0.0:
        logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    return logits


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B,S) -> logits (B,S,V) float32 (the prefill). On the card
    every attention layer is one ``flash_attention`` launch."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    for r in range(cfg.num_repeats):
        for i, kind in enumerate(cfg.pattern):
            x = block_apply(cfg, kind, block_params(params, i, r), x,
                            positions=positions)
    for i, kind in enumerate(cfg.tail):
        x = block_apply(cfg, kind, params["tail_blocks"][i], x,
                        positions=positions)
    return _logits(cfg, params, x)


# ----------------------------------------------------------- decode ------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device: Optional[torch.device] = None) -> dict:
    """Per-pattern-position stacked caches, leaves (R, B, S, kvH, dh):
    ``window`` slots for ``local`` layers, else ``max_len``, never more
    than ``max_len``."""
    check_supported(cfg)
    dt = _dtype(cfg)

    def one(kind, R):
        S = min(cfg.window if kind == "local" else max_len, max_len)
        shape = (R, batch, S, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    return {"scan": [one(kind, cfg.num_repeats) for kind in cfg.pattern],
            "tail": [_map(lambda a: a[0], one(kind, 1))
                     for kind in cfg.tail]}


def serve_step(cfg: ArchConfig, params, states, tokens: torch.Tensor,
               pos: torch.Tensor):
    """One decode step. tokens (B, 1); pos (B,) int32 absolute positions.
    -> (logits (B, 1, V) float32, states). The caches in ``states`` are
    updated IN PLACE and returned (the reference returns new ones). On
    the card every attention layer is one ``flash_decode`` launch."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    positions = pos[:, None]
    for r in range(cfg.num_repeats):
        for i, kind in enumerate(cfg.pattern):
            st = _map(lambda a: a[r], states["scan"][i])
            x, _ = block_decode(cfg, kind, block_params(params, i, r), x,
                                st, pos=pos, positions=positions)
    for i, kind in enumerate(cfg.tail):
        x, _ = block_decode(cfg, kind, params["tail_blocks"][i], x,
                            states["tail"][i], pos=pos, positions=positions)
    return _logits(cfg, params, x), states
