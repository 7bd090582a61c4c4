"""arctic-480b [moe] 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L, d_model=7168, 56 heads (GQA kv=8, head_dim=128), d_ff=4864,
MoE 128e top-2 with a dense FFN residual in parallel, vocab=32000.
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="arctic-480b",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    pattern=("attn",),
    moe=True,
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    act="silu",
    tie_embeddings=False,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=256, moe_d_ff=256, num_experts=4, top_k=2,
        vocab_size=512, dtype="float32", capacity_factor=4.0)
