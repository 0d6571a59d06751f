"""Interaction protocols (paper §IV-E, Definitions 1-2, Theorems 1-2),
counterpart of ``repro.core.protocols``.

An interaction protocol is characterized by the binary relation R it imposes
on parent-child model pairs. Equivalence protocols (BSBODP+SKR, R = V x V)
allow any non-root node to migrate under any other parent (Theorem 1);
partial-order protocols may refuse a move (Theorem 2).
``FLAlgorithm.migrate`` consults ``allows_migration`` before every
re-parenting. The relations and ``aggregate_params`` run on the port's
trees of tensors (the relations read only shapes, so numpy leaves do too).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Protocol:
    name: str
    kind: str  # "equivalence" | "partial_order"
    # relation(model_a, model_b) -> bool: is <a, b> in R?
    relation: Callable[[object, object], bool]

    def allows_migration(self, model_of, node: str, new_parent: str) -> bool:
        """Can ``node`` become a child of ``new_parent``?"""
        if self.kind == "equivalence":
            return True  # Theorem 1
        a, b = model_of(node), model_of(new_parent)
        if a is None or b is None:
            # the algorithm exposes no per-node models: the partial-order
            # relation is unverifiable, so the move must be refused (the
            # safe direction under Theorem 2)
            return False
        return bool(self.relation(a, b))


def _structure(tree):
    """A hashable description of a tree's containers (dict keys sorted,
    list and tuple kept apart, as ``jax.tree.structure`` compares them)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return "*"


def _leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def same_structure(a, b) -> bool:
    if _structure(a) != _structure(b):
        return False
    return all(tuple(x.shape) == tuple(y.shape)
               for x, y in zip(_leaves(a), _leaves(b)))


def is_submodel(a, b) -> bool:
    """a ⊑ b: every leaf of a exists in b with dims <= b's (partial training)."""
    fa = dict(_flat(a))
    fb = dict(_flat(b))
    if not set(fa) <= set(fb):
        return False
    return all(
        len(fa[k].shape) == len(fb[k].shape)
        and all(x <= y for x, y in zip(fa[k].shape, fb[k].shape))
        for k in fa
    )


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# The three protocols used in the experiments ------------------------------

PARAM_AVG = Protocol("parameter-averaging", "equivalence", same_structure)
BSBODP_SKR = Protocol("bsbodp+skr", "equivalence", lambda a, b: True)
PARTIAL_TRAIN = Protocol("partial-training", "partial_order", is_submodel)


def aggregate_params(children_params: list, weights: list[float]):
    """FedAvg aggregation, Eq. (2): data-size weighted parameter average.
    The weights are normalized first, in Python floats; each leaf is then
    the fp32 sum of ``w * x`` in child order, cast back to the first
    child's dtype, as the reference's ``sum(w * x.astype(f32) ...)``."""
    total = sum(weights)
    ws = [w / total for w in weights]

    def avg(*xs):
        acc = ws[0] * xs[0].float()
        for w, x in zip(ws[1:], xs[1:]):
            acc = acc + w * x.float()
        return acc.to(xs[0].dtype)

    return tree_map(avg, *children_params)
