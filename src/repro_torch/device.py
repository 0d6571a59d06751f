"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and nothing moves to the CPU on its own."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and
    there is no card.

    On CUDA it also turns TF32 off for matmuls and cuDNN convolutions, so
    the port's fp32 models compute in fp32, as the reference's do.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class on_meta(torch.overrides.TorchFunctionMode):
    """Inside ``with on_meta():`` every tensor a torch function makes lands
    on the ``meta`` device, whatever device it names: shapes and dtypes,
    no storage. So an entry point called with ``device="cpu"`` builds its
    tree for nothing, a full-size model included (the reference's
    ``jax.eval_shape``). Random draws take a CPU generator's place and do
    nothing."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)
