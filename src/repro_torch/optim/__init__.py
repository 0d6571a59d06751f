"""Functional optimizers over parameter trees of tensors."""
from repro_torch.optim.optimizers import adamw_init, adamw_update  # noqa: F401
