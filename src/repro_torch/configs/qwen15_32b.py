"""qwen1.5-32b [dense] QKV bias [hf:Qwen/Qwen1.5-0.5B family].

64L, d_model=5120, 40 heads (GQA kv=40 == MHA), d_ff=27392, vocab=152064.
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="qwen1.5-32b",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    pattern=("attn",),
    qkv_bias=True,
    act="silu",
    tie_embeddings=False,
    rope_theta=1000000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=2, d_model=256, num_heads=8, num_kv_heads=8,
        head_dim=32, d_ff=512, vocab_size=512, dtype="float32")
