"""Evaluation metrics for the FL plane, counterpart of ``repro.fl.metrics``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_leaves


@torch.no_grad()
def accuracy(apply_fn, params, x: np.ndarray, y: np.ndarray,
             batch: int = 256) -> float:
    """Top-1 accuracy of ``apply_fn(params, ·)`` on NHWC images ``x``,
    predicted in batches of ``batch`` on the parameters' device."""
    dev = tree_leaves(params)[0].device
    correct = 0
    for i in range(0, len(y), batch):
        xb = torch.as_tensor(x[i : i + batch]).to(dev)
        pred = apply_fn(params, xb).argmax(dim=-1).cpu().numpy()
        correct += int((pred == y[i : i + batch]).sum())
    return correct / len(y)
