"""AdamW and the learning-rate schedule on trees of tensors (counterpart
of ``repro.optim``)."""
from .adamw import (AdamWConfig, adamw_update, global_norm, init_opt_state,
                    opt_state_specs)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_update", "cosine_schedule", "global_norm",
           "init_opt_state", "opt_state_specs"]
