"""The transformer substrate (dense attention, MoE, SSD and RG-LRU
blocks, M-RoPE, the enc-dec model's encoder and cross-attention;
prefill, training and decode, the experts sharded over a ``model`` mesh
axis), the port's ``repro.models.transformer``."""
from repro_torch.models.transformer.common import ArchConfig
from repro_torch.models.transformer.model import (encode, forward,
                                                  init_decode_state,
                                                  init_params, lm_loss,
                                                  make_train_step,
                                                  params_from_numpy,
                                                  serve_step)
from repro_torch.models.transformer.moe import moe_apply, moe_shard

__all__ = ["ArchConfig", "init_params", "params_from_numpy", "encode",
           "forward", "lm_loss", "make_train_step", "init_decode_state",
           "serve_step", "moe_apply", "moe_shard"]
