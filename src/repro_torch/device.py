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
