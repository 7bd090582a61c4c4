"""granite-3-2b [dense] GQA [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=49155.
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="granite-3-2b",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    pattern=("attn",),
    act="silu",
    tie_embeddings=True,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, dtype="float32")
