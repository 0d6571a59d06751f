"""AdamW as a pure function over parameter trees.

Counterpart of ``repro.optim.optimizers.adamw_*``, matched term for term:
b2 = 0.95 by default, eps added outside the square root, fp32 moments
whatever the parameter dtype, an integer step counter, and no weight decay
on parameters with fewer than two dimensions (norm scales, biases).
``torch.optim.AdamW`` differs on each of these, so the port does not use it.

API:
  state = adamw_init(params)
  new_params, new_state = adamw_update(grads, state, params, lr=..., ...)
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


@torch.no_grad()
def adamw_update(
    grads,
    state,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        wd = weight_decay if p.ndim >= 2 else 0.0  # no decay on norms/biases
        pf = p.to(torch.float32)
        newp = pf - lr * (delta + wd * pf)
        return newp.to(p.dtype), m, v

    out = [
        upd(*leaves) for leaves in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state["m"]), tree_leaves(state["v"]))
    ]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_params, {"step": step, "m": new_m, "v": new_v}
