"""Evaluation metrics for the FL plane, counterpart of ``repro.fl.metrics``."""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs.metrics import global_registry
from repro_torch.tree import tree_leaves


@torch.no_grad()
def accuracy(apply_fn, params, x: np.ndarray, y: np.ndarray,
             batch: int = 256) -> float:
    """Top-1 accuracy of ``apply_fn(params, ·)`` on NHWC images ``x``,
    predicted in batches of ``batch`` on the parameters' device. Each call
    observes its host seconds in ``fl_eval_wall_seconds`` (the predictions
    are read back to the host, so on a card they include the device's
    work)."""
    t0 = time.perf_counter()  # analysis: allow[DET001] host-side eval timing metric
    dev = tree_leaves(params)[0].device
    correct = 0
    for i in range(0, len(y), batch):
        xb = torch.as_tensor(x[i : i + batch]).to(dev)
        pred = apply_fn(params, xb).argmax(dim=-1).cpu().numpy()
        correct += int((pred == y[i : i + batch]).sum())
    global_registry().histogram("fl_eval_wall_seconds").observe(
        time.perf_counter() - t0)  # analysis: allow[DET001]
    return correct / len(y)
