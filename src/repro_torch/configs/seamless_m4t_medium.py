"""seamless-m4t-medium [audio] enc-dec, multimodal [arXiv:2308.11596].

12 encoder + 12 decoder layers, d_model=1024, 16 heads (GQA kv=16 == MHA),
d_ff=4096, vocab=256206. The speech frontend (mel-spectrogram + conv
feature extractor) is STUBBED per the assignment: ``input_specs`` provides
precomputed frame embeddings (B, S_src, d_model); this config implements
the transformer backbone (encoder + text decoder with cross-attention).
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="seamless-m4t-medium",
    kind="encdec",
    num_layers=12,
    num_enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    pattern=("attn",),
    qkv_bias=True,
    act="gelu",
    tie_embeddings=True,
    frontend="audio",
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    """2-layer smoke variant (same family, CPU-sized)."""
    return dataclasses.replace(
        ARCH, num_layers=2, num_enc_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        dtype="float32")
