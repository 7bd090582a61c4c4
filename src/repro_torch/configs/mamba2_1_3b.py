"""mamba2-1.3b [ssm] SSD state-space duality [arXiv:2405.21060].

48L, d_model=2048 (attention-free), ssm_state=128, expand 2 (d_inner
4096, 64 heads of dim 64), conv 4, vocab=50280. Sub-quadratic by
construction -> native long_500k support.
"""
import dataclasses

from repro_torch.models.transformer.common import ArchConfig

ARCH = ArchConfig(
    name="mamba2-1.3b",
    num_layers=48,
    d_model=2048,
    num_heads=64,            # ssm heads (d_inner / ssm_head_dim)
    num_kv_heads=64,
    head_dim=64,
    d_ff=0,                  # attention-free: no FFN sub-block
    vocab_size=50280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        ARCH, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=64, ssm_state=16, ssm_head_dim=64, ssm_chunk=16,
        vocab_size=512, dtype="float32")
