"""Deterministic fault injection: lossy transfers, link flaps, regional

The port's own copy of ``repro.sim.faults`` (numpy and the standard library
only); the two must stay identical in behaviour, which
``tests/test_torch_sim.py`` holds them to.

outages, and mid-transfer departures.

``FaultPlan`` is a frozen description of *how hostile* the network is;
``FaultProcess`` owns all fault randomness, drawn from dedicated
``SeedSequence``-derived streams (one per concern) so the full fault /
retry event schedule is a pure function of (scenario, seed, fault plan)
— and so fault draws never perturb the churn or training streams. With
no plan (or an all-zero plan) the engine never touches a fault stream
and event signatures are bit-identical to the pre-fault simulator.

Failure model (fail-fast): a transfer failure is decided at the instant
an attempt *starts*, so the whole retry schedule — capped exponential
backoff with seeded jitter, per-item deadline, retry exhaustion,
mid-transfer departure — is decidable before any training work runs.
Items whose every attempt fails are never executed; the scheduler
notifies the trainer via ``FLAlgorithm.on_item_failed`` and the
dependency graph degrades (downstream items run on partial inputs)
instead of deadlocking. See docs/robustness.md.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np

from repro_torch.core.topology import Tree, link_kind

# one named substream per fault concern; indices are part of the on-disk
# determinism contract (checkpoints snapshot the generator states, not
# the seeds) — append, never reorder
_STREAMS: Tuple[str, ...] = ("loss", "backoff", "flap", "outage", "departure")
_BYZANTINE_STREAM = len(_STREAMS)  # label-noise draws (pre-run, not a process)


@dataclass(frozen=True)
class FaultPlan:
    """Frozen description of the fault regime (docs/robustness.md)."""

    name: str
    description: str = ""

    # -- lossy transfers ---------------------------------------------------
    transfer_loss_prob: float = 0.0  # per-attempt loss chance, all links
    # per-link-kind overrides: (("end-edge", p), ("edge-cloud", p), ...)
    link_loss_prob: Tuple[Tuple[str, float], ...] = ()

    # -- retry policy ------------------------------------------------------
    max_retries: int = 3
    backoff_base_s: float = 0.5  # first wait; doubles per retry
    backoff_cap_s: float = 8.0
    backoff_jitter: float = 0.25  # +-25% seeded jitter on each wait
    deadline_s: float = 0.0  # 0 = no per-item deadline

    # -- link flaps --------------------------------------------------------
    link_flap_prob: float = 0.0  # per-link per-round chance of flapping
    flap_s: Tuple[float, float] = (5.0, 20.0)  # flap window (uniform)
    flap_loss_prob: float = 0.9  # loss prob while the link is flapping

    # -- correlated regional outages ---------------------------------------
    regional_outage_prob: float = 0.0  # per-edge per-round chance
    outage_s: Tuple[float, float] = (10.0, 30.0)  # outage window (uniform)

    # -- mid-transfer departure --------------------------------------------
    departure_prob: float = 0.0  # per failed attempt: node left mid-transfer
    departure_s: Tuple[float, float] = (5.0, 15.0)  # offline window

    # -- byzantine label noise (applied to client data pre-run) ------------
    label_noise_frac: float = 0.0  # fraction of clients that are byzantine
    label_noise_prob: float = 0.0  # per-sample flip chance on those clients

    def active(self) -> bool:
        """Whether the engine needs a ``FaultProcess`` at all. Label noise
        is excluded: it rewrites client data before the run and injects no
        transfer faults."""
        return (
            self.transfer_loss_prob > 0
            or any(p > 0 for _, p in self.link_loss_prob)
            or self.link_flap_prob > 0
            or self.regional_outage_prob > 0
            or self.departure_prob > 0
        )

    def with_overrides(self, **kw) -> "FaultPlan":
        return replace(self, **kw)


@dataclass(frozen=True)
class AttemptSchedule:
    """Pre-drawn fate of one work item's transfer attempts.

    ``events`` are (time, kind, payload) triples the engine pushes through
    the event queue; ``t_final`` is the instant the item's fate is sealed
    — transfer may begin (outcome "ok") or the item is dead (terminal
    ``pair_abandoned`` / ``pair_timeout`` already in ``events``)."""

    events: Tuple[Tuple[float, str, dict], ...]
    t_final: float
    outcome: str  # ok | abandoned | timeout | departed
    retries: int = 0
    failures: int = 0
    retry_wait_s: float = 0.0  # total backoff time spent waiting
    offline_until: float | None = None  # set when outcome == "departed"


@dataclass
class FaultAction:
    """One round-boundary fault event (regional outage or link flap)."""

    kind: str  # outage | flap
    node: str
    until: float = 0.0
    members: Tuple[str, ...] = field(default_factory=tuple)


class FaultProcess:
    """All fault randomness for one simulation, one seeded stream per
    concern (loss / backoff / flap / outage / departure)."""

    def __init__(self, tree: Tree, plan: FaultPlan, seed: int = 0):
        self.tree = tree
        self.plan = plan
        self._rng = {
            name: np.random.default_rng(np.random.SeedSequence([seed, i]))
            for i, name in enumerate(_STREAMS)
        }
        self.flapped_until: dict[str, float] = {}
        # mirror ChurnProcess membership: edges fixed at construction
        devices = set(
            tree.devices or (v for v in tree.nodes if tree.is_leaf(v))
        )
        self.edges: list[str] = sorted(
            v for v in tree.nodes if v != tree.root and v not in devices
        )

    # -- per-attempt draws -------------------------------------------------

    def loss_prob(self, node: str, now: float) -> float:
        """Effective per-attempt loss probability on the link above
        ``node`` at time ``now`` (flap window > per-link override >
        plan-wide scalar)."""
        p = self.plan.transfer_loss_prob
        kind = link_kind(self.tree, node)
        for k, pk in self.plan.link_loss_prob:
            if k == kind:
                p = pk
                break
        if self.flapped_until.get(node, -np.inf) > now:
            p = max(p, self.plan.flap_loss_prob)
        return p

    def _transfer_fails(self, node: str, now: float) -> bool:
        p = self.loss_prob(node, now)
        if p <= 0.0:
            return False
        return bool(self._rng["loss"].random() < p)

    def _backoff_s(self, attempt: int) -> float:
        plan = self.plan
        wait = min(plan.backoff_base_s * (2.0 ** attempt), plan.backoff_cap_s)
        if plan.backoff_jitter > 0:
            wait *= 1.0 + plan.backoff_jitter * float(
                2.0 * self._rng["backoff"].random() - 1.0
            )
        return wait

    def _departs(self, now: float) -> float | None:
        """Mid-transfer departure draw, made once per failed attempt."""
        plan = self.plan
        if plan.departure_prob <= 0:
            return None
        if self._rng["departure"].random() >= plan.departure_prob:
            return None
        return now + float(self._rng["departure"].uniform(*plan.departure_s))

    # -- the retry schedule ------------------------------------------------

    def plan_attempts(self, node: str, start: float,
                      comp: float) -> AttemptSchedule:
        """Pre-draw the full transfer-attempt schedule for the item on
        ``node`` that begins computing at ``start`` and is transfer-ready
        ``comp`` seconds later. Fail-fast semantics: each attempt's fate is
        decided at its start, failures cost only the backoff wait, and the
        deadline bounds when an attempt may *begin*."""
        plan = self.plan
        deadline = start + plan.deadline_s if plan.deadline_s > 0 else None
        s = start + comp
        attempt = 0
        wait = 0.0
        total_wait = 0.0
        events: list[tuple[float, str, dict]] = []
        while True:
            if deadline is not None and s > deadline + 1e-9:
                events.append((deadline, "pair_timeout",
                               {"attempts": attempt}))
                return AttemptSchedule(tuple(events), deadline, "timeout",
                                       retries=max(attempt - 1, 0),
                                       failures=attempt,
                                       retry_wait_s=total_wait)
            if attempt > 0:
                events.append((s, "pair_retried",
                               {"attempt": attempt, "wait": round(wait, 6)}))
            if not self._transfer_fails(node, s):
                return AttemptSchedule(tuple(events), s, "ok",
                                       retries=attempt, failures=attempt,
                                       retry_wait_s=total_wait)
            events.append((s, "pair_failed", {"attempt": attempt}))
            until = self._departs(s)
            if until is not None:
                events.append((s, "pair_abandoned",
                               {"attempts": attempt + 1,
                                "reason": "departed"}))
                return AttemptSchedule(tuple(events), s, "departed",
                                       retries=attempt, failures=attempt + 1,
                                       retry_wait_s=total_wait,
                                       offline_until=until)
            if attempt >= plan.max_retries:
                events.append((s, "pair_abandoned",
                               {"attempts": attempt + 1,
                                "reason": "retries"}))
                return AttemptSchedule(tuple(events), s, "abandoned",
                                       retries=attempt, failures=attempt + 1,
                                       retry_wait_s=total_wait)
            wait = self._backoff_s(attempt)
            total_wait += wait
            s += wait
            attempt += 1

    # -- round-boundary draws ----------------------------------------------

    def draw_round(self, r: int, now: float, is_online) -> list[FaultAction]:
        """Regional outages and link flaps for the round starting at
        ``now``; iteration order is sorted, one stream per concern."""
        plan = self.plan
        actions: list[FaultAction] = []

        if plan.regional_outage_prob > 0:
            for e in self.edges:
                if not is_online(e, now):
                    continue
                if self._rng["outage"].random() < plan.regional_outage_prob:
                    until = now + float(
                        self._rng["outage"].uniform(*plan.outage_s))
                    members = tuple(sorted(
                        c for c in self.tree.children.get(e, ())
                    ))
                    actions.append(FaultAction("outage", e, until=until,
                                               members=members))

        if plan.link_flap_prob > 0:
            for v in sorted(self.tree.parent):
                if self.flapped_until.get(v, -np.inf) > now:
                    continue
                if self._rng["flap"].random() < plan.link_flap_prob:
                    until = now + float(
                        self._rng["flap"].uniform(*plan.flap_s))
                    self.flapped_until[v] = until
                    actions.append(FaultAction("flap", v, until=until))

        return actions

    # -- checkpointing -----------------------------------------------------

    def state(self) -> dict:
        """JSON-serializable snapshot (generator states carry >64-bit ints
        — JSON handles them, msgpack would not)."""
        return {
            "rng": {name: g.bit_generator.state
                    for name, g in self._rng.items()},
            "flapped_until": dict(self.flapped_until),
        }

    def load_state(self, state: dict) -> None:
        for name, g in self._rng.items():
            g.bit_generator.state = state["rng"][name]
        self.flapped_until = {
            str(k): float(v) for k, v in state["flapped_until"].items()
        }


# ---------------------------------------------------------------------------
# Byzantine label noise (pre-run data rewrite, not a FaultProcess concern)
# ---------------------------------------------------------------------------


def apply_label_noise(
    plan: FaultPlan,
    client_data: dict[str, tuple[np.ndarray, np.ndarray]],
    seed: int,
    num_classes: int,
) -> tuple[dict[str, tuple[np.ndarray, np.ndarray]], set[str]]:
    """Flip labels on a seeded subset of clients (byzantine_noise
    scenario): ``label_noise_frac`` of clients each flip every sample with
    ``label_noise_prob`` to a uniformly-drawn *other* class. Runs before
    trainer construction — FedEEC's embedding stores see the noisy labels,
    which is exactly the regime SKR's self-rectification targets."""
    if plan.label_noise_frac <= 0 or plan.label_noise_prob <= 0:
        return client_data, set()
    # one-shot pre-run rewrite: a dedicated substream of the fault seed,
    # not a FaultProcess stream (no process exists before the trainer)
    rng = np.random.default_rng(  # analysis: allow[DET004] pre-run, seeded substream
        np.random.SeedSequence([seed, _BYZANTINE_STREAM]))
    names = sorted(client_data)
    k = int(round(plan.label_noise_frac * len(names)))
    if k == 0:
        return client_data, set()
    byzantine = {
        str(v) for v in rng.choice(names, size=k, replace=False)
    }
    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for v in names:
        x, y = client_data[v]
        if v in byzantine:
            y = np.array(y, copy=True)
            flip = rng.random(len(y)) < plan.label_noise_prob
            offsets = rng.integers(1, num_classes, size=len(y))
            y[flip] = (y[flip] + offsets[flip]) % num_classes
        out[v] = (x, y)
    return out, byzantine


# ---------------------------------------------------------------------------
# Named fault plans
# ---------------------------------------------------------------------------

FAULT_PLANS: dict[str, FaultPlan] = {}


def register_fault_plan(plan: FaultPlan) -> FaultPlan:
    assert plan.name not in FAULT_PLANS, f"duplicate fault plan {plan.name!r}"
    FAULT_PLANS[plan.name] = plan
    return plan


def get_fault_plan(name: str) -> FaultPlan:
    if name not in FAULT_PLANS:
        raise KeyError(
            f"unknown fault plan {name!r}; known: {sorted(FAULT_PLANS)}"
        )
    return FAULT_PLANS[name]


def list_fault_plans() -> list[str]:
    return sorted(FAULT_PLANS)


register_fault_plan(FaultPlan(
    "none",
    "No faults — the pre-fault simulator, bit-identical signatures.",
))

register_fault_plan(FaultPlan(
    "lossy",
    "Lossy access links: 15% per-attempt transfer loss on end-edge links, "
    "5% on edge-cloud, capped-backoff retries.",
    transfer_loss_prob=0.05,
    link_loss_prob=(("end-edge", 0.15),),
    max_retries=3,
    backoff_base_s=0.5,
    backoff_cap_s=8.0,
    backoff_jitter=0.25,
))

register_fault_plan(FaultPlan(
    "regional",
    "Correlated regional outages: an edge and all its clients drop "
    "together for tens of simulated seconds, plus mild link loss.",
    regional_outage_prob=0.15,
    outage_s=(15.0, 45.0),
    transfer_loss_prob=0.05,
))

register_fault_plan(FaultPlan(
    "flaky_links",
    "Link flaps: individual links degrade to 90% loss for a window, "
    "over a mildly lossy baseline.",
    link_flap_prob=0.10,
    flap_s=(5.0, 20.0),
    flap_loss_prob=0.9,
    transfer_loss_prob=0.02,
))

register_fault_plan(FaultPlan(
    "chaos",
    "Everything at once: heavy loss, tight retry budget and deadline, "
    "mid-transfer departures, flaps, and regional outages.",
    transfer_loss_prob=0.20,
    max_retries=2,
    deadline_s=30.0,
    departure_prob=0.10,
    link_flap_prob=0.10,
    regional_outage_prob=0.10,
))

register_fault_plan(FaultPlan(
    "byzantine",
    "Label-noise clients (no transfer faults): 30% of clients flip half "
    "their labels — the regime SKR's rectification claim targets.",
    label_noise_frac=0.3,
    label_noise_prob=0.5,
))
