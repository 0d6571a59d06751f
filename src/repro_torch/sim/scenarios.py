"""Scenario registry: one ``ScenarioConfig`` per named network condition.

The port's own copy of ``repro.sim.scenarios`` (numpy and the standard library
only); the two must stay identical in behaviour, which
``tests/test_torch_sim.py`` holds them to.

A scenario bundles the link tiers, the compute model (base step time +
straggler population), and the churn process (dropout / rejoin /
mobility / scripted trace). Scenarios are frozen dataclasses so a
(scenario, seed) pair fully determines a simulation.

    from repro_torch.sim import get_scenario
    sc = get_scenario("mobile_clients")
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from repro_torch.sim.faults import FaultPlan, get_fault_plan
from repro_torch.sim.network import (
    DEFAULT_EDGE_CLOUD,
    DEFAULT_END_EDGE,
    DEFAULT_OTHER,
    LinkSpec,
)


@dataclass(frozen=True)
class TraceEntry:
    """One scripted churn action for trace replay: at the start of round
    ``round`` apply ``kind`` in {dropout, migrate, rejoin} to ``node``.
    ``target`` names the destination edge for migrations; ``duration_s``
    is the offline window for dropouts."""

    round: int
    kind: str
    node: str
    target: str = ""
    duration_s: float = 0.0


@dataclass(frozen=True)
class ScenarioConfig:
    name: str
    description: str = ""

    # -- link tiers --------------------------------------------------------
    end_edge: LinkSpec = DEFAULT_END_EDGE
    edge_cloud: LinkSpec = DEFAULT_EDGE_CLOUD
    other: LinkSpec = DEFAULT_OTHER

    # -- compute model -----------------------------------------------------
    # nominal seconds per distillation step on a leaf; interior tiers are
    # faster by tier_speedup per tier above the leaves
    base_step_s: float = 0.02
    tier_speedup: float = 4.0
    straggler_frac: float = 0.0  # fraction of leaves that are stragglers
    straggler_slowdown: float = 1.0  # compute multiplier for stragglers

    # -- stochastic churn (per round) -------------------------------------
    dropout_prob: float = 0.0  # per-leaf chance of going offline
    edge_dropout_prob: float = 0.0  # per-edge chance of going offline
    dropout_s: Tuple[float, float] = (5.0, 30.0)  # offline window (uniform)
    migration_prob: float = 0.0  # per-leaf chance of re-parenting (mobility)

    # -- scripted churn ----------------------------------------------------
    mass_migration_round: int = -1  # round index; -1 disables
    mass_migration_frac: float = 0.0  # fraction of leaves moved that round
    trace: Tuple[TraceEntry, ...] = ()

    # -- fault injection (repro_torch.sim.faults; docs/robustness.md) ------
    # None or an inactive plan keeps the engine on the fault-free fast
    # path, whose event signatures are bit-identical to pre-fault builds
    faults: Optional[FaultPlan] = None

    # -- population scale (docs/simulator.md) ------------------------------
    # declared device population represented by the materialized tree: 0
    # means "the tree IS the population"; > 0 splits `population` devices
    # into one homogeneous cohort per materialized leaf (sizes differing
    # by at most one) and feeds the cohort sizes to the trainer as
    # aggregation-weight multipliers — exact FedAvg equivalence when
    # cohort members are homogeneous
    population: int = 0

    # -- link contention (docs/simulator.md) -------------------------------
    # fair-share backhaul pricing: transfers that overlap in simulated
    # time under one parent divide its bandwidth instead of enjoying
    # independent pipes. Off by default — legacy signatures untouched.
    fair_share: bool = False

    def with_overrides(self, **kw) -> "ScenarioConfig":
        return replace(self, **kw)


SCENARIOS: dict[str, ScenarioConfig] = {}

# CLI conveniences resolved by get_scenario; NOT in list_scenarios(), so
# the scenarios.json signature table keys only canonical names
ALIASES: dict[str, str] = {"straggler": "straggler_heavy"}


def register_scenario(sc: ScenarioConfig) -> ScenarioConfig:
    assert sc.name not in SCENARIOS, f"duplicate scenario {sc.name!r}"
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> ScenarioConfig:
    name = ALIASES.get(name, name)
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        )
    return SCENARIOS[name]


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


# ---------------------------------------------------------------------------
# Named scenarios
# ---------------------------------------------------------------------------

register_scenario(ScenarioConfig(
    "stable",
    "Ideal EEC-NET: static topology, homogeneous compute, clean links.",
))

register_scenario(ScenarioConfig(
    "mobile_clients",
    "Vehicular/pedestrian ends (§IV-E): frequent re-parenting between "
    "edges plus occasional connectivity loss while moving.",
    migration_prob=0.25,
    dropout_prob=0.15,
    dropout_s=(2.0, 10.0),
    end_edge=LinkSpec(latency_s=0.035, bandwidth_Bps=6 * 1e6 / 8, spread=0.4),
))

register_scenario(ScenarioConfig(
    "flaky_edge",
    "Unreliable edge servers: whole-edge outages take their subtree "
    "offline for tens of simulated seconds.",
    edge_dropout_prob=0.30,
    dropout_prob=0.05,
    dropout_s=(10.0, 40.0),
))

register_scenario(ScenarioConfig(
    "straggler_heavy",
    "Severe end-device heterogeneity: 40% of leaves compute 8x slower, "
    "stretching the round critical path.",
    straggler_frac=0.4,
    straggler_slowdown=8.0,
))

register_scenario(ScenarioConfig(
    "mass_migration",
    "Flash-crowd handover: half of all ends re-parent simultaneously "
    "mid-training (paper §IV-E at scale).",
    mass_migration_round=1,
    mass_migration_frac=0.5,
    dropout_prob=0.05,
))

register_scenario(ScenarioConfig(
    "flash_crowd",
    "Stadium-event surge: a mass handover wave at round 1 while the "
    "access links are congested and ends intermittently drop.",
    mass_migration_round=1,
    mass_migration_frac=0.5,
    dropout_prob=0.10,
    dropout_s=(2.0, 8.0),
    end_edge=LinkSpec(latency_s=0.040, bandwidth_Bps=4 * 1e6 / 8, spread=0.4),
))

register_scenario(ScenarioConfig(
    "lossy_links",
    "Hostile access network: per-attempt transfer loss on both hops with "
    "capped-backoff retries (fault plan 'lossy', docs/robustness.md).",
    faults=get_fault_plan("lossy"),
))

register_scenario(ScenarioConfig(
    "regional_outage",
    "Correlated regional failures: an edge and all its clients drop "
    "together for tens of seconds (fault plan 'regional').",
    faults=get_fault_plan("regional"),
))

register_scenario(ScenarioConfig(
    "byzantine_noise",
    "Byzantine label-noise clients over mild churn: 30% of clients flip "
    "half their labels, stressing SKR's self-rectification claim.",
    dropout_prob=0.10,
    dropout_s=(2.0, 10.0),
    faults=get_fault_plan("byzantine"),
))

register_scenario(ScenarioConfig(
    "megacity",
    "Metropolitan population: 120k declared devices trained through "
    "weighted cohorts on a representative sample, with mild churn and "
    "fair-share contention on the shared edge backhaul.",
    population=120_000,
    dropout_prob=0.05,
    dropout_s=(5.0, 20.0),
    straggler_frac=0.2,
    straggler_slowdown=4.0,
    fair_share=True,
))

register_scenario(ScenarioConfig(
    "trace_replay",
    "Scripted churn from a trace: deterministic dropouts/migrations at "
    "fixed rounds (stand-in for real mobility traces).",
    trace=(
        TraceEntry(0, "dropout", "client1", duration_s=12.0),
        TraceEntry(1, "migrate", "client0", target="edge1"),
        TraceEntry(1, "dropout", "client3", duration_s=6.0),
        TraceEntry(2, "migrate", "client2", target="edge0"),
    ),
))
