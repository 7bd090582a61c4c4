"""gemma2-2b [dense] local+global alternating, logit softcap
[arXiv:2408.00118].

26L, d_model=2304, 8 heads (GQA kv=4, head_dim=256), d_ff=9216,
vocab=256000. Pattern (local, global) with window 4096; attention logit
softcap 50, final logit softcap 30; sandwich (post) norms; embeddings
scaled by sqrt(d_model).
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="gemma2-2b",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    embed_scale=True,
    act="gelu",
    tie_embeddings=True,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, window=16, dtype="float32")
