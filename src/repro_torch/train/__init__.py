from repro_torch.train.optim import (AdamW, AdamWState, SGD, cosine_schedule,
                                     global_norm, opt_state_from_numpy)
from repro_torch.train.checkpoint import (CheckpointCorruptError,
                                          checkpoint_step, latest_step,
                                          load_checkpoint, load_run_state,
                                          save_checkpoint, save_run_state)

__all__ = ["AdamW", "AdamWState", "SGD", "cosine_schedule", "global_norm",
           "opt_state_from_numpy", "save_checkpoint", "load_checkpoint",
           "checkpoint_step", "CheckpointCorruptError", "save_run_state",
           "load_run_state", "latest_step"]
