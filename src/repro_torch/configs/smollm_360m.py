"""smollm-360m [dense] llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

32L, d_model=960, 15 heads (GQA kv=5), d_ff=2560, vocab=49152.
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="smollm-360m",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    pattern=("attn",),
    act="silu",
    tie_embeddings=True,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=2, d_model=240, num_heads=5,   # keeps 15/5 ratio
        num_kv_heads=5, head_dim=48, d_ff=512, vocab_size=512,
        dtype="float32")
