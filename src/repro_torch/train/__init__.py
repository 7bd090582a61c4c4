from repro_torch.train.optim import (AdamW, AdamWState, SGD, cosine_schedule,
                                     global_norm, opt_state_from_numpy)
from repro_torch.train.checkpoint import (CheckpointCorruptError,
                                          checkpoint_step, load_checkpoint,
                                          save_checkpoint)

__all__ = ["AdamW", "AdamWState", "SGD", "cosine_schedule", "global_norm",
           "opt_state_from_numpy", "save_checkpoint", "load_checkpoint",
           "checkpoint_step", "CheckpointCorruptError"]
