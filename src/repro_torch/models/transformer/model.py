"""Model assembly: the decoder-only LM and the enc-dec model's prefill
(``encode``, ``forward``), loss and train step (``lm_loss``,
``make_train_step``) and decode (``init_decode_state``, ``serve_step``):
the port's ``repro/models/transformer/model.py``.

The parameter tree has the reference's layout: ``embed``,
``final_norm``, ``lm_head`` when embeddings are untied, ``blocks`` (one
dict per pattern position, every leaf stacked over the repeat dimension
R), ``tail_blocks``, and for enc-dec ``enc_blocks`` (one ``attn`` tree
stacked over the encoder's layers) and ``enc_norm``; an enc-dec
decoder block also holds ``ln_x`` and ``xattn``. Where the reference
scans over R, the port loops in Python, applying the pattern positions
in the same order inside each repeat; when a gradient is needed each
repeat's body runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so only the residual stream between repeats is kept
for the backward. Every block kind runs (``attn``, ``local``, ``ssm``,
``rglru``, dense FFN or MoE), with M-RoPE where the config has sections.
The frontends are stubs, as in the reference: ``forward`` takes
precomputed patch embeddings (``embeds``) and ``encode`` precomputed
frame embeddings, each (B, S, d_model).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer.blocks import (KINDS, block_apply,
                                                   block_decode,
                                                   init_block_params)
from repro_torch.models.transformer.common import (ArchConfig, dense_init,
                                                   rms_norm, softcap)
from repro_torch.train.optim import tree_leaves, tree_map


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a block kind the transformer does not know."""
    for kind in cfg.pattern + cfg.tail:
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _put(dst, src, r: int) -> None:
    """Copy each leaf of ``src`` into ``dst``'s leaf at ``[r]``."""
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k], r)
    else:
        dst[r].copy_(src)


def _stacked(make, R: int):
    """R trees from ``make()``, in call order, stacked on a new leading
    dimension: each leaf is allocated once at (R, ...) and filled repeat
    by repeat, so one repeat's tree lives beside the stack, where
    stacking a list of R trees would hold the whole position twice."""
    tree = make()
    out = _map(lambda a: a.new_empty((R, *a.shape)), tree)
    for r in range(R):
        _put(out, tree if r == 0 else make(), r)
        tree = None
    return out


def _unstack(tree):
    """A pattern position's stacked tree -> one tree of views a repeat,
    from one ``unbind`` a leaf: its backward is one stack, where R
    ``a[r]`` selects would each write a whole-stack gradient."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        R = len(next(iter(per.values())))
        return [{k: v[r] for k, v in per.items()} for r in range(R)]
    return tree.unbind(0)


# ------------------------------------------------------------- init ------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Parameters with the reference's layout and init law (normal draws
    with std ``fan_in ** -0.5`` in float32, cast to the config's dtype;
    norms zero), drawn from ``generator`` on its own device and placed
    on ``device`` (default: the generator's). The draws differ from
    ``jax.random``'s; ``params_from_numpy`` carries the reference's.
    The float32 leaves of the SSM and RG-LRU mixers stay float32 in a
    bfloat16 model, as the reference keeps them. An enc-dec model's
    encoder is drawn last."""
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
    cross = cfg.kind == "encdec"
    params["blocks"] = [
        _stacked(lambda: init_block_params(cfg, kind, generator, dt, device,
                                           with_cross=cross), R)
        for kind in cfg.pattern]
    params["tail_blocks"] = [
        init_block_params(cfg, kind, generator, dt, device, with_cross=cross)
        for kind in cfg.tail]
    if cross:
        params["enc_blocks"] = [_stacked(
            lambda: init_block_params(cfg, "attn", generator, dt, device),
            cfg.num_enc_layers)]
        params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                         device=device)
    return params


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (the reference's ``init_params`` output moved
    through ``np.asarray``) -> the same tree of tensors on ``device``,
    each leaf in its own dtype (bfloat16 included)."""
    return _map(lambda a: _tensor_from_numpy(a).to(device), tree)


# ---------------------------------------------------------- forward ------

def _embed(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows, through ``F.embedding``: its backward sums each
    row's repeated tokens in a fixed order on the CPU and on the card,
    where the backward of ``embed[tokens]`` (an accumulating
    ``index_put_``) adds them in a thread-dependent order on the CPU."""
    dt = _dtype(cfg)
    x = F.embedding(tokens.long(), params["embed"]).to(dt)
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
    if logits.requires_grad:
        return softcap(logits, cfg.final_softcap)
    if cfg.final_softcap > 0.0:
        logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    return logits


def _needs_remat(params) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))


def encode(cfg: ArchConfig, params, enc_embeds: torch.Tensor
           ) -> torch.Tensor:
    """The encoder over stub frontend embeddings (B, S_src, d): non-causal
    ``attn`` blocks at positions ``arange(S_src)``, then ``enc_norm``;
    -> (B, S_src, d) in the model's dtype. Without a gradient every
    layer on the card is one ``flash_attention`` launch."""
    check_supported(cfg)
    x = enc_embeds.to(_dtype(cfg))
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    layers = _unstack(params["enc_blocks"][0])
    remat = _needs_remat(params)

    def body(h, r):
        return block_apply(cfg, "attn", layers[r], h, positions=pos,
                           causal=False)

    for r in range(cfg.num_enc_layers):
        x = checkpoint(body, x, r, use_reentrant=False) if remat \
            else body(x, r)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            mrope_positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            mesh=None) -> torch.Tensor:
    """tokens (B,S) -> logits (B,S,V) float32. ``embeds`` (B,S,d), the
    frontend stub's output, is added onto the token embeddings in the
    model's dtype; ``mrope_positions`` (3,B,S) are M-RoPE's (t, h, w)
    streams; ``enc_out`` (B,S_src,d), from ``encode``, feeds each
    block's cross-attention. Without a gradient (the prefill) every
    attention layer on the card is one ``flash_attention`` launch (two
    in an enc-dec decoder block: self and cross); with one, the chunked
    attention, each repeat rematerialised in the backward. ``mesh`` (a
    ``("data", "model")`` mesh) shards the experts over its ``model``
    axis (``moe_apply``)."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    if embeds is not None:
        x = x + embeds.to(x.dtype)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    layers = [_unstack(b) for b in params["blocks"]]
    remat = _needs_remat(params)
    kw = dict(positions=positions, mrope_positions=mrope_positions,
              enc_out=enc_out, mesh=mesh)

    def body(h, r):
        for i, kind in enumerate(cfg.pattern):
            h = block_apply(cfg, kind, layers[i][r], h, **kw)
        return h

    for r in range(cfg.num_repeats):
        x = checkpoint(body, x, r, use_reentrant=False) if remat \
            else body(x, r)
    for i, kind in enumerate(cfg.tail):
        x = block_apply(cfg, kind, params["tail_blocks"][i], x, **kw)
    return _logits(cfg, params, x)


def lm_loss(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor],
            mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over ``loss_mask`` (all ones when absent) from
    float32 logits: ``batch`` holds ``tokens``, ``labels`` (B,S) on the
    parameters' device, and where the config needs them
    ``mrope_positions``, ``embeds`` and (enc-dec) ``enc_embeds``, which
    go through ``encode``. ``mesh`` as ``forward`` takes it."""
    enc_out = (encode(cfg, params, batch["enc_embeds"])
               if cfg.kind == "encdec" else None)
    logits = forward(cfg, params, batch["tokens"],
                     mrope_positions=batch.get("mrope_positions"),
                     embeds=batch.get("embeds"), enc_out=enc_out,
                     mesh=mesh)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"loss": loss}


def _or_zeros(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like) if g is None else g


def make_train_step(cfg: ArchConfig, optimizer, mesh=None):
    """-> step(params, opt_state, batch) -> (params, opt_state, aux): the
    reference's ``value_and_grad(lm_loss)`` and optimizer update, through
    ``torch.autograd``. The parameters and the optimizer's moments are
    overwritten in place and returned (the reference returns new trees),
    so at full width one copy of each lives on the card. Over an
    in-process ``mesh`` the gradient flows through the sharded experts'
    views unchanged."""

    def step(params, opt_state, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, _ = lm_loss(cfg, p, batch, mesh=mesh)
        # a leaf the loss does not reach (a stack of no repeats) gets a
        # zero gradient, as ``jax.grad`` gives it
        it = iter(torch.autograd.grad(loss, tree_leaves(p),
                                      allow_unused=True))
        grads = tree_map(lambda t: _or_zeros(next(it), t), params)
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             inplace=True)
        return params, opt_state, {"loss": loss.detach()}

    return step


# ----------------------------------------------------------- decode ------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device: Optional[torch.device] = None,
                      src_len: int = 0, window_override: int = 0) -> dict:
    """Per-pattern-position stacked caches, leaves (R, B, ...): k/v (R, B,
    S, kvH, dh) with ``window`` slots for ``local`` layers, else
    ``window_override`` slots when it is > 0 (the sliding-window variant
    of full attention, a ring buffer ``block_decode`` wraps), else
    ``max_len``; never more than ``max_len``. ``ssm`` conv (R, B, K-1,
    d_inner + 2n) in the model's dtype and ssm (R, B, h, p, n) float32;
    ``rglru`` conv (R, B, K-1, w) and h (R, B, w) float32; for enc-dec
    also the cross caches xk/xv (R, B, src_len, kvH, dh) in the model's
    dtype and x_len (R, B) int32, all zero (the caller writes the
    encoder's k/v and lengths into them)."""
    check_supported(cfg)
    dt = _dtype(cfg)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def mixer(kind, R):
        if kind == "ssm":
            return {"conv": zeros((R, batch, cfg.ssm_conv - 1,
                                   cfg.d_inner + 2 * cfg.ssm_state)),
                    "ssm": zeros((R, batch, cfg.ssm_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state),
                                 torch.float32)}
        if kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            return {"conv": zeros((R, batch, cfg.ssm_conv - 1, w)),
                    "h": zeros((R, batch, w), torch.float32)}
        S = cfg.window if kind == "local" else (
            window_override if window_override > 0 else max_len)
        S = min(S, max_len)
        shape = (R, batch, S, cfg.num_kv_heads, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}

    def one(kind, R):
        st = mixer(kind, R)
        if cfg.kind == "encdec":
            shape = (R, batch, src_len, cfg.num_kv_heads, cfg.head_dim)
            st.update(xk=zeros(shape), xv=zeros(shape),
                      x_len=zeros((R, batch), torch.int32))
        return st

    return {"scan": [one(kind, cfg.num_repeats) for kind in cfg.pattern],
            "tail": [_map(lambda a: a[0], one(kind, 1))
                     for kind in cfg.tail]}


def serve_step(cfg: ArchConfig, params, states, tokens: torch.Tensor,
               pos: torch.Tensor, *,
               mrope_positions: Optional[torch.Tensor] = None,
               mesh=None, window_override: int = 0):
    """One decode step. tokens (B, 1); pos (B,) int32 absolute positions;
    ``mrope_positions`` (3, B, 1) M-RoPE's streams where the config has
    sections (else RoPE at ``pos``). -> (logits (B, 1, V) float32,
    states). The caches in ``states`` are updated IN PLACE and returned
    (the reference returns new ones). On the card every attention layer
    is one ``flash_decode`` launch, and an enc-dec block's
    cross-attention over its ``xk``/``xv`` one more; the SSM and RG-LRU
    states are overwritten in place too. With tp > 1 ``model`` shards in
    ``mesh`` each self-attention cache is sequence-sharded over them, still
    one ``flash_decode`` launch a layer, and the experts are sharded.
    ``window_override`` is the reference's argument: the window of a
    full-attention cache is its size, fixed by ``init_decode_state``, so
    it changes nothing here."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens)
    positions = pos[:, None]
    layers = [_unstack(b) for b in params["blocks"]]
    for r in range(cfg.num_repeats):
        for i, kind in enumerate(cfg.pattern):
            st = _map(lambda a: a[r], states["scan"][i])
            x, _ = block_decode(cfg, kind, layers[i][r], x, st, pos=pos,
                                positions=positions,
                                mrope_positions=mrope_positions, mesh=mesh,
                                window_override=window_override)
    for i, kind in enumerate(cfg.tail):
        x, _ = block_decode(cfg, kind, params["tail_blocks"][i], x,
                            states["tail"][i], pos=pos, positions=positions,
                            mrope_positions=mrope_positions, mesh=mesh,
                            window_override=window_override)
    return _logits(cfg, params, x), states
