"""The transformer substrate's decoder (dense attention, MoE, SSD and
RG-LRU blocks; prefill, training and decode), the port's
``repro.models.transformer``."""
from repro_torch.models.transformer.common import ArchConfig
from repro_torch.models.transformer.model import (forward, init_decode_state,
                                                  init_params, lm_loss,
                                                  make_train_step,
                                                  params_from_numpy,
                                                  serve_step)

__all__ = ["ArchConfig", "init_params", "params_from_numpy", "forward",
           "lm_loss", "make_train_step", "init_decode_state", "serve_step"]
