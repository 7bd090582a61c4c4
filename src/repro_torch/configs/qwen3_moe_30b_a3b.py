"""qwen3-moe-30b-a3b [moe] 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32 heads (GQA kv=4, head_dim=128, q/k-norm), expert
d_ff=768, MoE 128e top-8, vocab=151936.
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="qwen3-moe-30b-a3b",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    pattern=("attn",),
    moe=True,
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
    qk_norm=True,
    act="silu",
    tie_embeddings=False,
    rope_theta=1000000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=128, moe_d_ff=128, num_experts=4, top_k=2,
        vocab_size=512, dtype="float32", capacity_factor=4.0)
