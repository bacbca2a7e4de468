"""Optimizers (twin of ``repro/optim``): AdamW and int8 gradient
compression."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    opt_state_specs,
)
