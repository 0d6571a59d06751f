"""Communication accounting (paper Table VII).

Every transfer between a node and its parent is recorded by link tier:
  "end-edge"   leaf <-> its parent
  "edge-cloud" non-leaf <-> root
  "other"      deeper hierarchies
Parameter-aggregation protocols move |W| floats both ways per round;
BSBODP moves |ε|+1 per sample once (init) and (|z|+1) per sample per
round per direction — exactly the complexity rows of Table VII.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

BYTES_PER_FLOAT = 4


class Span:
    """Bytes recorded between ``span()`` enter and exit, by link kind —
    the unit the simulator converts into transfer time."""

    def __init__(self):
        self.by_link: dict[str, float] = {}

    @property
    def total(self) -> float:
        return sum(self.by_link.values())


class CommMeter:
    def __init__(self):
        self.bytes = defaultdict(float)
        self.events = defaultdict(int)

    def record(self, link: str, num_floats: float, note: str = ""):
        self.bytes[link] += num_floats * BYTES_PER_FLOAT
        self.events[link] += 1

    @contextmanager
    def span(self):
        """Context manager capturing the byte delta of a block, so callers
        (the sim engine) can price individual work items."""
        before = dict(self.bytes)
        sp = Span()
        try:
            yield sp
        finally:
            sp.by_link = {
                k: v - before.get(k, 0.0)
                for k, v in self.bytes.items()
                if v - before.get(k, 0.0) > 0.0
            }

    def link_kind(self, tree, child: str) -> str:
        from repro_torch.core.topology import link_kind

        return link_kind(tree, child)

    def summary(self) -> dict[str, float]:
        return dict(self.bytes)
