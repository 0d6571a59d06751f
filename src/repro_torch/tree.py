"""Parameter trees: nested dicts and lists of tensors.

The port keeps the JAX package's parameter layout — the same nested dict /
list structure and key names — so that the converter maps one tree onto
the other leaf by leaf. These helpers are the few tree operations the
trainer and the optimizer need.
"""
from __future__ import annotations

from typing import Callable

import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in a fixed depth-first order (dict insertion order)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_stack(trees):
    """Stack same-structure trees leafwise along a new leading axis: the
    tree of a group of B trees (``jax.tree.map(jnp.stack)`` of the
    reference's batched pair path)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree, B: int) -> list:
    """The B trees of a stacked tree, each owning its own tensors: a later
    in-place update of one (the serial AdamW step) writes neither the
    group's buffer nor another tree."""
    return [tree_map(lambda x, b=b: x[b].clone(), tree) for b in range(B)]


def value_and_grad(loss_fn: Callable, params, *args):
    """``jax.value_and_grad`` over a parameter tree: the detached loss and a
    tree of gradients shaped like ``params``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def tree_unflatten(like, leaves) -> object:
    """Rebuild a tree shaped like ``like`` from ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
