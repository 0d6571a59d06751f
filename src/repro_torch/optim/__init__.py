"""Functional optimizers and LR schedules over parameter trees of tensors."""
from repro_torch.optim.optimizers import (  # noqa: F401
    adamw_init,
    adamw_update_,
    adamw_update_stacked_,
    clip_by_global_norm,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine  # noqa: F401
