"""Shape-only stand-ins for every (arch x input shape) combination of the
dry-run: the port of ``repro/launch/specs.py``.

Nothing here allocates memory: parameters, optimizer state, batches and
decode caches are tensors on the ``meta`` device (``init_params(...,
device="meta")`` draws nothing), the counterpart of the reference's
``jax.eval_shape`` and ``ShapeDtypeStruct``s. Each input carries its
placement spec from ``dist.shardings``. The step functions are the
port's own -- ``lm_loss`` and ``AdamW.update`` through
``make_train_step``, ``encode`` and ``forward``, ``serve_step`` -- with
``mesh=mesh`` and ``window_override`` as the reference passes them, so
``launch.dryrun`` can trace them shape-only.

Frontend stubs: [audio] provides ``enc_embeds`` (B, S_src, d) frame
embeddings; [vlm] provides ``embeds`` (B, S, d) patch embeddings plus
M-RoPE position streams (3, B, S).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import INPUT_SHAPES, SUBQUADRATIC, get_arch
from repro_torch.dist.mesh import dp_axes
from repro_torch.dist.shardings import (batch_shardings,
                                        decode_state_shardings, fit_spec,
                                        map_specs, opt_shardings,
                                        param_shardings)
from repro_torch.models.transformer import (encode, forward,
                                            init_decode_state, init_params,
                                            make_train_step, serve_step)
from repro_torch.models.transformer.common import ArchConfig
from repro_torch.train.optim import AdamW

#: window for the sliding-window long_500k variant on full-attention archs
LONG_WINDOW = 8_192
#: encoder/cross source length for enc-dec decode shapes
SRC_LEN = 4_096

META = torch.device("meta")


@dataclasses.dataclass
class DryRunSpec:
    arch: str
    shape: str
    fn: Callable                    # the step, traced by launch.dryrun
    args: Tuple[Any, ...]           # trees of meta tensors
    in_shardings: Tuple[Any, ...]   # trees of dist.shardings.Spec
    out_shardings: Any
    meta: Dict[str, Any]


def _meta_params(cfg: ArchConfig):
    return init_params(cfg, torch.Generator(), device=META)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, B: int, S: int
                      ) -> Dict[str, torch.Tensor]:
    batch = {
        "tokens": _sds((B, S), torch.int32),
        "labels": _sds((B, S), torch.int32),
        "loss_mask": _sds((B, S), torch.float32),
    }
    if cfg.mrope_sections:
        batch["mrope_positions"] = _sds((3, B, S), torch.int32)
    if cfg.frontend == "vision":
        batch["embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16)
    if cfg.kind == "encdec":
        batch["enc_embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16)
    return batch


def materialize(tree, device, generator: torch.Generator):
    """Each shape-only leaf of ``tree`` -> a tensor of its shape and
    dtype on ``device``: floating leaves drawn N(0, 0.02) in place from
    ``generator`` (on ``device``), integer and bool leaves zero (token 0,
    position 0, an empty cross cache). The containers are kept, so the
    result feeds the spec's step and its specs size it."""
    def leaf(t):
        out = torch.empty(t.shape, dtype=t.dtype, device=device)
        if out.is_floating_point():
            return out.normal_(0.0, 0.02, generator=generator)
        return out.zero_()
    return map_specs(leaf, tree)


def cost_variant_cfg(cfg: ArchConfig, r: int, S: int) -> ArchConfig:
    """Small unrolled variant for roofline cost measurement: r repeats of
    the pattern, single-chunk attention (the reference's: its compiler's
    cost analysis counts a scan body once; here it keeps the trace
    short)."""
    changes = dict(num_layers=len(cfg.pattern) * r, unroll_layers=True,
                   attn_q_chunk=S, attn_kv_chunk=S)
    if cfg.kind == "encdec":
        changes["num_enc_layers"] = r
    return dataclasses.replace(cfg, **changes)


def make_dryrun_spec(arch: str, shape: str, mesh,
                     optimizer: Optional[AdamW] = None,
                     cfg: Optional[ArchConfig] = None,
                     S: Optional[int] = None,
                     B: Optional[int] = None) -> DryRunSpec:
    cfg = cfg or get_arch(arch)
    S_d, B_d, kind = INPUT_SHAPES[shape]
    S = S or S_d
    B = B or B_d
    optimizer = optimizer or AdamW(lr=1e-4, weight_decay=0.01,
                                   max_grad_norm=1.0)
    params_s = _meta_params(cfg)
    params_sh = param_shardings(cfg, mesh, params_s)
    meta: Dict[str, Any] = {"cfg": cfg, "seq": S, "batch": B, "kind": kind}

    if kind == "train":
        opt_s = optimizer.init(params_s)
        opt_sh = opt_shardings(params_sh, opt_s)
        batch_s = train_batch_specs(cfg, B, S)
        batch_sh = batch_shardings(cfg, mesh, batch_s)
        step = make_train_step(cfg, optimizer, mesh=mesh)

        def train_step(params, opt_state, batch):
            p2, o2, aux = step(params, opt_state, batch)
            return p2, o2, aux["loss"]

        return DryRunSpec(arch, shape, train_step,
                          (params_s, opt_s, batch_s),
                          (params_sh, opt_sh, batch_sh),
                          (params_sh, opt_sh, None), meta)

    if kind == "prefill":
        batch_s = train_batch_specs(cfg, B, S)
        batch_s.pop("labels")
        batch_s.pop("loss_mask")
        batch_sh = batch_shardings(cfg, mesh, batch_s)

        @torch.no_grad()
        def prefill_step(params, batch):
            enc_out = (encode(cfg, params, batch["enc_embeds"])
                       if cfg.kind == "encdec" else None)
            logits = forward(cfg, params, batch["tokens"],
                             mrope_positions=batch.get("mrope_positions"),
                             embeds=batch.get("embeds"), enc_out=enc_out,
                             mesh=mesh)
            return logits[:, -1]          # next-token logits

        return DryRunSpec(arch, shape, prefill_step, (params_s, batch_s),
                          (params_sh, batch_sh), None, meta)

    # ---- decode ----
    window_override = 0
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        window_override = LONG_WINDOW
        meta["attn_variant"] = "sliding_window"
    src_len = SRC_LEN if cfg.kind == "encdec" else 0
    state_s = init_decode_state(cfg, B, S, device=META, src_len=src_len,
                                window_override=window_override)
    state_sh = decode_state_shardings(cfg, mesh, state_s)
    tok_s = _sds((B, 1), torch.int32)
    pos_s = _sds((B,), torch.int32)
    dp = dp_axes(mesh)
    tok_sh = fit_spec(mesh, (dp, None), (B, 1))
    pos_sh = fit_spec(mesh, (dp,), (B,))

    @torch.no_grad()
    def decode_step(params, states, tokens, pos, mrope_positions=None):
        return serve_step(cfg, params, states, tokens, pos,
                          mrope_positions=mrope_positions, mesh=mesh,
                          window_override=window_override)

    args = (params_s, state_s, tok_s, pos_s)
    in_sh = (params_sh, state_sh, tok_sh, pos_sh)
    if cfg.mrope_sections:
        args = args + (_sds((3, B, 1), torch.int32),)
        in_sh = in_sh + (fit_spec(mesh, (None, dp, None), (3, B, 1)),)
    return DryRunSpec(arch, shape, decode_step, args, in_sh,
                      (None, state_sh), meta)
