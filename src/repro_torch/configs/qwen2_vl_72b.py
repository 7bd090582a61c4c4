"""qwen2-vl-72b [vlm] M-RoPE, dynamic resolution [arXiv:2409.12191].

80L, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=29568,
vocab=152064. M-RoPE sections (16, 24, 24) over the 64 head_dim/2
frequency bands. The ViT vision encoder + projector are STUBBED per the
assignment: ``input_specs`` provides patch embeddings (B, S, d_model)
added onto token embeddings, plus the (3, B, S) M-RoPE position streams.
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="qwen2-vl-72b",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=("attn",),
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    act="silu",
    tie_embeddings=False,
    rope_theta=1000000.0,
    frontend="vision",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, mrope_sections=(4, 6, 6),
        dtype="float32")
