"""Interaction protocols (paper §IV-E, Definitions 1-2, Theorems 1-2),
counterpart of ``repro.core.protocols``.

An interaction protocol is characterized by the binary relation R it imposes
on parent-child model pairs. Equivalence protocols (BSBODP+SKR, R = V x V)
allow any non-root node to migrate under any other parent (Theorem 1);
partial-order protocols may refuse a move (Theorem 2).
``FLAlgorithm.migrate`` consults ``allows_migration`` before every
re-parenting. The parameter-averaging and partial-training protocols come
with the baselines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


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


BSBODP_SKR = Protocol("bsbodp+skr", "equivalence", lambda a, b: True)
