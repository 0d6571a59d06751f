"""AdamW and global-norm clipping over parameter trees.

Counterpart of ``repro.optim.optimizers.adamw_*`` and
``clip_by_global_norm``, matched term for term: b2 = 0.95 by default, eps
added outside the square root, fp32 moments whatever the parameter dtype,
an integer step counter, and no weight decay on parameters with fewer than
two dimensions (norm scales, biases). ``torch.optim.AdamW`` differs on each
of these, so the port does not use it.

API:
  state = adamw_init(params)
  params, state = adamw_update_(grads, state, params, lr=..., ...)  # in place
  grads, norm = clip_by_global_norm(grads, max_norm)
  params, state = adamw_update_stacked_(grads, state, params, lr=...)
      # B trees stacked leafwise (tree_stack), one step counter each

The reference's ``adamw_update`` is pure; ``adamw_update_`` computes its
update with the same fp32 operations, leaf by leaf, into ``params`` and
``state`` themselves: at llama3.2-3b's size the fp32 moments alone are 8
bytes a parameter (25.7 GB), and a second copy of them would not fit on an
NVIDIA H100 80GB HBM3 beside the weights, gradients and activations
(``launch.steps``). Its callers (the LM train step, FedEEC's student steps,
the autoencoder's pre-training) keep no other reference to the old trees.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so that their global L2 norm is at most ``max_norm``.
    The norm is taken in fp32 over the leaves in tree order; each leaf is
    scaled in fp32 and cast back to its dtype. Returns (grads, norm)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), gn


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


@torch.no_grad()
def adamw_update_(
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
    """One AdamW step written into the leaves of ``params``, ``state["m"]``
    and ``state["v"]`` one leaf at a time, so no second copy of the moments
    or the parameters is ever held. The fp32 expressions are the
    reference's, term for term. Returns (params, state), the same objects,
    with ``state["step"]`` advanced (a new tensor)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1, bc2 = 1.0 - b1**t, 1.0 - b2**t
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        wd = weight_decay if p.ndim >= 2 else 0.0  # no decay on norms/biases
        _leaf_update_(p, g, m, v, bc1, bc2, lr, b1, b2, eps, wd)
    state["step"] = step
    return params, state


@torch.no_grad()
def adamw_update_stacked_(
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
    """``adamw_update_`` for B trees stacked leafwise along a leading axis
    (``tree_stack`` of B trees and of their states): ``state["step"]`` is
    (B,), one counter per tree, since the trees of a group may have taken
    different numbers of steps. Slice b of every leaf gets exactly
    ``adamw_update_``'s update of tree b: the same fp32 expressions, with
    tree b's bias corrections, and weight decay by the rank of tree b's
    leaf."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1, bc2 = 1.0 - b1**t, 1.0 - b2**t
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        # (B, 1, ..., 1): a bare (B,) would broadcast against the last axis
        shape = (-1,) + (1,) * (p.ndim - 1)
        wd = weight_decay if p.ndim - 1 >= 2 else 0.0
        _leaf_update_(p, g, m, v, bc1.view(shape), bc2.view(shape), lr, b1, b2, eps, wd)
    state["step"] = step
    return params, state


def _leaf_update_(p, g, m, v, bc1, bc2, lr, b1, b2, eps, wd):
    """The reference's fp32 AdamW expressions for one leaf, in place."""
    g = g.to(torch.float32)
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    del g
    delta = m / bc1
    delta.div_(torch.sqrt_(v / bc2).add_(eps))
    pf = p.to(torch.float32)
    delta.add_(wd * pf).mul_(lr)
    if pf is p:
        p.sub_(delta)
    else:
        p.copy_(pf.sub_(delta))
