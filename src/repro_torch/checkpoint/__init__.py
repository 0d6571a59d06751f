"""Checkpoints in the reference's msgpack format (``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import load_pytree, save_pytree  # noqa: F401
