"""Per-link latency/bandwidth models for the EEC-NET.

The port's own copy of ``repro.sim.network`` (numpy and the standard library
only); the two must stay identical in behaviour, which
``tests/test_torch_sim.py`` holds them to.

Links are classified by the same tiers ``CommMeter`` uses ("end-edge",
"edge-cloud", "other"); each tier has a ``LinkSpec`` (one-way latency +
bandwidth), and every concrete link gets a deterministic per-link speed
factor so that two clients under the same edge don't share an identical
channel (cf. HierFL / HFEL latency models).

Transfer time of n bytes over the link above ``child``:

    t = latency + n / (bandwidth * speed_factor(child))

With fair-share contention enabled (``ScenarioConfig.fair_share``,
docs/simulator.md), transfers that overlap in simulated time under one
parent divide that parent's backhaul: a transfer starting while k-1
others are in flight on sibling links is priced at k times its solo
serialization time (latency unchanged). Off by default — the solo
formula above is the legacy path and its signatures are untouched.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.topology import Tree, link_kind  # noqa: F401  (re-export)

MBPS = 1e6 / 8  # bytes/second per megabit-per-second


@dataclass(frozen=True)
class LinkSpec:
    """One link tier: one-way latency (s), bandwidth (bytes/s), and the
    half-width of the uniform per-link speed spread (0.2 → ±20%)."""

    latency_s: float
    bandwidth_Bps: float
    spread: float = 0.2


# Nominal tiers: wireless access (end-edge), metro backhaul (edge-cloud).
DEFAULT_END_EDGE = LinkSpec(latency_s=0.020, bandwidth_Bps=10 * MBPS)
DEFAULT_EDGE_CLOUD = LinkSpec(latency_s=0.050, bandwidth_Bps=100 * MBPS)
DEFAULT_OTHER = LinkSpec(latency_s=0.030, bandwidth_Bps=50 * MBPS)


class NetworkModel:
    """Maps (link, bytes) -> seconds. Per-link speed factors are drawn once
    from the seed, so the network is heterogeneous but fully reproducible.
    Factors are keyed by node name, not topology position: they follow a
    client through migrations (its radio doesn't change when it re-parents).
    """

    def __init__(
        self,
        tree: Tree,
        *,
        end_edge: LinkSpec = DEFAULT_END_EDGE,
        edge_cloud: LinkSpec = DEFAULT_EDGE_CLOUD,
        other: LinkSpec = DEFAULT_OTHER,
        seed: int = 0,
    ):
        self.tree = tree
        self.specs = {"end-edge": end_edge, "edge-cloud": edge_cloud,
                      "other": other}
        rng = np.random.default_rng(seed)
        self._factor: dict[str, float] = {}
        for v in sorted(tree.parent):  # sorted → independent of dict order
            spread = self.specs[link_kind(tree, v)].spread
            self._factor[v] = float(1.0 + rng.uniform(-spread, spread))
        # hot-path cache: (latency, EFFECTIVE bandwidth) per child, the
        # effective bandwidth being the exact spec-bandwidth x per-link
        # factor product the formula multiplies — transfer_s is one dict
        # get + one divide. Migration can re-tier a non-device link, so
        # entries are dropped on re-parent.
        self._eff: dict[str, tuple[float, float]] = {}
        tree.on_migrate(self._on_migrate)
        # fair-share occupancy: parent -> [(start, end)] of in-flight
        # transfers this round (only populated when the engine prices
        # through transfer_shared_s)
        self._occupancy: dict[str, list[tuple[float, float]]] = {}

    def _on_migrate(self, node: str, old: str, new: str) -> None:
        self._eff.pop(node, None)

    def spec(self, child: str) -> LinkSpec:
        return self.specs[link_kind(self.tree, child)]

    def speed_factor(self, child: str) -> float:
        return self._factor.get(child, 1.0)

    def _effective(self, child: str) -> tuple[float, float]:
        eff = self._eff.get(child)
        if eff is None:
            s = self.specs[link_kind(self.tree, child)]
            eff = self._eff[child] = (
                s.latency_s,
                s.bandwidth_Bps * self._factor.get(child, 1.0))
        return eff

    def transfer_s(self, child: str, nbytes: float) -> float:
        """Seconds to move ``nbytes`` across the link above ``child``."""
        if nbytes <= 0:
            return 0.0
        eff = self._eff.get(child) or self._effective(child)
        return eff[0] + nbytes / eff[1]

    # -- fair-share contention (docs/simulator.md) -------------------------

    def reset_contention(self) -> None:
        """Forget in-flight transfers; the engine calls this at each round
        boundary (rounds are barriers — nothing spans them)."""
        self._occupancy.clear()

    def transfer_shared_s(self, child: str, nbytes: float,
                          start: float) -> float:
        """Fair-share transfer pricing: ``nbytes`` over the link above
        ``child`` beginning at simulated time ``start``, where the k-1
        transfers already in flight under the same parent at ``start``
        shrink this one's bandwidth share to 1/k. Monotone by
        construction: every concurrent transfer can only raise k, and a
        transfer's own price never changes after it is recorded."""
        if nbytes <= 0:
            return 0.0
        lat, ebw = self._effective(child)
        parent = self.tree.parent.get(child, "")
        active = self._occupancy.setdefault(parent, [])
        k = 1 + sum(1 for s, e in active if s <= start < e)
        dur = lat + nbytes * k / ebw
        active.append((start, start + dur))
        return dur
