"""Shared transformer substrate: the unified arch config, norms, RoPE and
M-RoPE.

The port's copy of ``repro/models/transformer/common.py``. ``ArchConfig``
is copied whole (same fields, same derived properties); the numerics are
PyTorch. The reference scans a layer stack over its repeat dimension;
the port loops over it in Python (``model.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    kind: str = "decoder"              # "decoder" | "encdec"
    num_layers: int = 12               # decoder layers
    num_enc_layers: int = 0            # encoder layers (encdec only)
    d_model: int = 1024
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 64
    d_ff: int = 4096
    vocab_size: int = 32000
    # block pattern, cycled over num_layers: entries in
    # {"attn", "local", "ssm", "rglru"}
    pattern: Tuple[str, ...] = ("attn",)
    # attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_softcap: float = 0.0          # gemma2 attention logit softcap
    final_softcap: float = 0.0         # gemma2 final logit softcap
    window: int = 0                    # sliding window for "local" blocks
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w)
    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False       # arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # RG-LRU (recurrentgemma)
    lru_width: int = 0
    # misc
    act: str = "silu"                  # "silu" | "gelu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    frontend: str = ""                 # "" | "audio" | "vision" (stubbed)
    dtype: str = "bfloat16"
    qk_norm: bool = False              # per-head q/k RMSNorm (qwen3)
    post_norms: bool = False           # sandwich norms (gemma2)
    embed_scale: bool = False          # scale embeddings by sqrt(d) (gemma)
    # cost-model controls (dry-run roofline): XLA cost_analysis counts a
    # scan body ONCE, so the roofline pipeline compiles small UNROLLED
    # variants and extrapolates (launch/dryrun.py)
    unroll_layers: bool = False
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # ---- beyond-paper perf options (EXPERIMENTS.md §Perf) ----
    # sequence-parallel training attention: shard the q/scores sequence
    # dim over `model` (k/v allgathered). Fixes head-count/TP mismatches
    # (e.g. smollm's 15 heads on TP=16, which GSPMD otherwise replicates).
    seq_shard_attn: bool = False
    # keep MoE expert weights resident per model-shard (no FSDP dim) --
    # removes the per-layer expert allgather; decode-friendly.
    moe_resident_experts: bool = False

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 so the vocab dim
        shards over any TP axis (Megatron-style); logits are sliced back
        to ``vocab_size``, semantics unchanged."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def num_repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def tail(self) -> Tuple[str, ...]:
        """Pattern positions of the trailing partial repeat (e.g.
        recurrentgemma-9b: 38 layers = 12 x (rglru,rglru,local) + 2)."""
        return self.pattern[: self.num_layers % len(self.pattern)]

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def activation(self):
        """SiLU, or GELU with the tanh approximation: ``jax.nn.gelu``'s
        default (``approximate=True``), which the reference uses."""
        if self.act == "silu":
            return F.silu
        return functools.partial(F.gelu, approximate="tanh")

    def param_counts(self) -> dict:
        """Analytic parameter counts (N for the 6ND roofline term)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = {}
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        per_layer["attn"] = attn + 2 * d
        per_layer["local"] = per_layer["attn"]
        per_layer["ffn"] = 3 * d * ff + d
        if self.moe:
            per_layer["moe"] = (self.num_experts * 3 * d * self.moe_d_ff
                                + d * self.num_experts + d)
            per_layer["moe_active"] = (self.top_k * 3 * d * self.moe_d_ff
                                       + d * self.num_experts + d)
        if "ssm" in self.pattern:
            di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer["ssm"] = (d * (2 * di + 2 * n + h) + di * d
                                + self.ssm_conv * (di + 2 * n) + 3 * h + d)
        if "rglru" in self.pattern:
            w = self.lru_width or d
            per_layer["rglru"] = (2 * d * w + w * d + 2 * w * w // 1
                                  + self.ssm_conv * w + 2 * d)
        total = emb
        active = emb
        for i in range(self.num_layers):
            kindl = self.pattern[i % len(self.pattern)]
            blk = per_layer.get(kindl, per_layer.get("attn"))
            total += blk
            active += blk
            if kindl != "ssm":          # every non-SSM block has FFN/MoE
                if self.moe:
                    total += per_layer["moe"]
                    active += per_layer["moe_active"]
                    if self.dense_residual:
                        total += per_layer["ffn"]
                        active += per_layer["ffn"]
                else:
                    total += per_layer["ffn"]
                    active += per_layer["ffn"]
        if self.kind == "encdec":
            enc = self.num_enc_layers * (per_layer["attn"] + per_layer["ffn"])
            xattn = self.num_layers * per_layer["attn"]
            total += enc + xattn
            active += enc + xattn
        return {"total": int(total), "active": int(active)}


# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + scale`` (the reference keeps
    the scale as an offset from 1), cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """1 / theta^(2i / head_dim) in float32, evaluated on the host and
    copied to ``device`` once: the card's ``pow`` rounds some bands an
    ulp away from the host's, which a position near 2^19 turns into an
    angle 0.03 rad off."""
    return _host_freqs(head_dim, float(theta), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _host_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
        return (1.0 / (theta ** exps)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, dh); positions (..., S) -> rotated x. The two halves
    of the head are rotated against each other (not interleaved
    pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # (dh/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, dh) rotated by the angles ang (..., S, dh/2), one
    per frequency band and shared by the heads."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions (3, ..., S); the dh/2
    frequency bands are split into (t, h, w) sections, each rotated by its
    own position stream (band j of section i reads ``positions[i]``)."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {dh // 2}")
    freqs = rope_freqs(dh, theta, x.device)               # (dh/2,)
    # the reference gathers each band's stream; slices of the bands give
    # the same products without an index tensor to copy to the card
    bands, lo = [], 0
    for i, n in enumerate(sections):
        bands.append(positions[i][..., None].float() * freqs[lo:lo + n])
        lo += n
    return _rotate(x, torch.cat(bands, dim=-1))           # (..., S, dh/2)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0.0 else x


def dense_init(generator: torch.Generator, shape: Tuple[int, ...],
               in_axis=0, dtype=torch.float32,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Normal draws with std ``fan_in ** -0.5``, in float32 then cast, as
    the reference's ``dense_init``; drawn on the generator's device and
    moved to ``device``. On the ``meta`` device nothing is drawn: the
    leaf is shape-only (the dry-run's counterpart of ``jax.eval_shape``)
    and the generator is left as it was."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if isinstance(in_axis, int):
        fan_in = shape[in_axis]
    else:
        fan_in = 1
        for a in in_axis:
            fan_in *= shape[a]
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * fan_in ** -0.5
    return w.to(dtype=dtype, device=device or generator.device)
