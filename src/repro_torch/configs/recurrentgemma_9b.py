"""recurrentgemma-9b [hybrid] RG-LRU + local attention 1:2
[arXiv:2402.19427].

38L (12 full (rglru, rglru, local) repeats + 2 tail rglru blocks),
d_model=4096, 16 heads MQA (kv=1, head_dim=256), d_ff=12288,
vocab=256000, window 2048, lru_width=4096. Sub-quadratic (recurrence +
windowed attention) -> native long_500k support.
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-9b",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    embed_scale=True,
    act="gelu",
    tie_embeddings=True,
    rope_theta=10000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=3, d_model=256, num_heads=4, num_kv_heads=1,
        head_dim=64, d_ff=512, vocab_size=512, window=16, lru_width=256,
        dtype="float32")
