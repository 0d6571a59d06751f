"""Critical-path attribution: which node/link/factor gated each round
(the port's own copy of ``repro.obs.critical_path``).

A round's simulated length is the longest dependency chain through its
work items (``pair_start``/``pair_done`` in the event log). This module
reconstructs that chain per round and attributes it:

* from a **raw event log** (``runner.py --out`` / ``RunResult.event_log``):
  item intervals come from the paired start/done events, straggler
  membership from the ``straggle`` notes — the compute/transfer split
  inside an item is not recorded there, so non-straggler gates report the
  combined factor;
* from a **Chrome trace** (``runner.py --trace``): item spans carry
  ``compute_s`` / ``transfer_s`` / ``straggle`` args, so the gate factor
  is exact.

Two items are precedence-related when one feeds the other (child item's
``peer`` is the parent item's ``node``) or they serialize on a shared
participant; the walk follows binding predecessors (finish time == start
time) backwards from the round's last-finishing item.

``explain(...)`` renders the per-round report behind
``runner.py --explain-rounds`` and ``python -m repro_torch.obs.report``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from statistics import median

EPS = 2e-6  # event-log times are rounded to 6 decimals


@dataclass
class Item:
    """One executed work item (a pair_start/pair_done interval)."""

    node: str
    peer: str
    start: float
    end: float
    bytes: float = 0.0
    kind: str = "pair"
    compute_s: float | None = None  # trace-only
    transfer_s: float | None = None  # trace-only
    straggle: float = 1.0  # compute factor of the slowest participant
    straggle_node: str = ""  # which participant that is (when > 1)
    retries: int = 0  # fault-plane transfer retries absorbed by this item
    retry_wait_s: float = 0.0  # backoff wait inside the interval (trace-only)

    @property
    def dur(self) -> float:
        return self.end - self.start

    def participants(self) -> set[str]:
        return {self.node, self.peer} - {""}


@dataclass
class RoundReport:
    round: int
    t0: float
    t_end: float  # last item completion (== round_end for barrier rounds)
    items: list[Item] = field(default_factory=list)
    path: list[Item] = field(default_factory=list)  # first -> last
    gate: Item | None = None
    gate_node: str = ""
    gate_factor: str = ""  # retry | straggle | compute | transfer | compute+transfer
    start_delay: float = 0.0  # path head started after t0 (migration busy)
    slack: list[float] = field(default_factory=list)  # off-path end slack

    @property
    def makespan(self) -> float:
        return self.t_end - self.t0

    @property
    def idle(self) -> bool:
        return not self.items


# ---------------------------------------------------------------------------
# Item extraction
# ---------------------------------------------------------------------------


def rounds_from_eventlog(entries: list[dict]) -> list[RoundReport]:
    """Group pair_start/pair_done intervals by round. ``entries`` is the
    simulator's event log (``RunResult.event_log`` or its JSON)."""
    stragglers: dict[str, float] = {}
    reports: list[RoundReport] = []
    cur: RoundReport | None = None
    open_items: dict[tuple[str, str], float] = {}
    for e in entries:
        kind = e["kind"]
        if kind == "straggle":
            stragglers[e["node"]] = float(e.get("slowdown", 1.0))
        elif kind == "round_start":
            cur = RoundReport(round=int(e["round"]), t0=e["t"], t_end=e["t"])
            reports.append(cur)
            open_items = {}
        elif cur is None:
            continue
        elif kind == "pair_start":
            open_items[(e["node"], e.get("target", ""))] = e["t"]
        elif kind == "pair_done":
            key = (e["node"], e.get("target", ""))
            start = open_items.pop(key, e["t"] - e.get("dur", 0.0))
            it = Item(node=key[0], peer=key[1], start=start, end=e["t"],
                      bytes=e.get("bytes", 0.0),
                      retries=int(e.get("retries", 0)))
            for v in sorted(it.participants()):
                if stragglers.get(v, 1.0) > it.straggle:
                    it.straggle = stragglers[v]
                    it.straggle_node = v
            cur.items.append(it)
            cur.t_end = max(cur.t_end, it.end)
    for rep in reports:
        _analyze(rep)
    return reports


def rounds_from_trace(trace: dict) -> list[RoundReport]:
    """Same reconstruction from Chrome-trace JSON written by
    ``Tracer.to_chrome`` — item spans carry exact compute/transfer args."""
    reports: dict[int, RoundReport] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        t0, t1 = ev.get("ts", 0.0) / 1e6, (ev.get("ts", 0.0) + ev.get("dur", 0.0)) / 1e6
        if ev.get("cat") == "round":
            r = int(args["round"])
            rep = reports.setdefault(r, RoundReport(round=r, t0=t0, t_end=t0))
            rep.t0, rep.t_end = t0, max(t0, t1)
        elif ev.get("cat") == "item":
            r = int(args["round"])
            rep = reports.setdefault(r, RoundReport(round=r, t0=t0, t_end=t0))
            it = Item(
                node=args.get("node", ev.get("name", "")),
                peer=args.get("peer", ""),
                start=t0, end=t1,
                bytes=args.get("bytes", 0.0),
                kind=args.get("kind", "pair"),
                compute_s=args.get("compute_s"),
                transfer_s=args.get("transfer_s"),
                straggle=args.get("straggle", 1.0),
                straggle_node=args.get("straggle_node", ""),
                retries=int(args.get("retries", 0)),
                retry_wait_s=args.get("retry_wait_s", 0.0),
            )
            rep.items.append(it)
            rep.t_end = max(rep.t_end, it.end)
    out = [reports[r] for r in sorted(reports)]
    for rep in out:
        _analyze(rep)
    return out


# ---------------------------------------------------------------------------
# Path reconstruction + attribution
# ---------------------------------------------------------------------------


def _related(a: Item, b: Item) -> bool:
    """Precedence-capable: dependency (a feeds b's node) or a shared
    participant the scheduler serializes on."""
    return a.peer == b.node or bool(a.participants() & b.participants())


def _analyze(rep: RoundReport) -> None:
    if not rep.items:
        return
    last = max(rep.items, key=lambda it: (it.end, it.dur))
    path = [last]
    cur = last
    while True:
        preds = [
            j for j in rep.items
            if j is not cur and abs(j.end - cur.start) <= EPS
            and _related(j, cur)
        ]
        if not preds:
            break
        # prefer true dependencies over co-located serialization, then the
        # longest contributor
        cur = max(preds, key=lambda j: (j.peer == cur.node, j.dur))
        path.insert(0, cur)
    rep.path = path
    rep.start_delay = max(0.0, path[0].start - rep.t0)
    rep.gate = max(path, key=lambda it: it.dur)
    # name the straggling participant when one gates; the child side else
    rep.gate_node = (rep.gate.straggle_node
                     if rep.gate.straggle > 1.0 and rep.gate.straggle_node
                     else rep.gate.node)
    rep.gate_factor = _factor(rep.gate)
    on_path = set(map(id, path))
    rep.slack = sorted(
        rep.t_end - it.end for it in rep.items if id(it) not in on_path
    )


def _factor(it: Item) -> str:
    if it.compute_s is not None and it.transfer_s is not None:
        # trace path: exact split — retry gates only when backoff wait
        # dominates both the compute and transfer legs
        if it.retry_wait_s > max(it.compute_s, it.transfer_s):
            return "retry"
        if it.straggle > 1.0:
            return "straggle"
        return "transfer" if it.transfer_s > it.compute_s else "compute"
    if it.straggle > 1.0:
        return "straggle"
    if it.retries > 0:
        # event-log path: the backoff wait is folded into the interval and
        # can't be split out, so any retried gate reports as retry-bound
        return "retry"
    return "compute+transfer"


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def explain(reports: list[RoundReport]) -> str:
    lines: list[str] = []
    for rep in reports:
        lines.append(f"== round {rep.round} ==")
        if rep.idle:
            lines.append("  idle (no schedulable items)")
            continue
        lines.append(
            f"  makespan {rep.makespan:10.3f} sim-s   "
            f"items {len(rep.items)}   critical path {len(rep.path)} item(s)"
        )
        if rep.start_delay > EPS:
            lines.append(
                f"  path head delayed {rep.start_delay:.3f}s past round "
                "start (migration transfer / enable time)"
            )
        span = max(rep.makespan, EPS)
        for it in rep.path:
            share = 100.0 * it.dur / span
            extra = ""
            if it.compute_s is not None and it.transfer_s is not None:
                extra = (f"  compute {it.compute_s:.3f}s"
                         f" transfer {it.transfer_s:.3f}s")
            if it.straggle > 1.0:
                extra += f"  straggle x{it.straggle:g}"
            if it.retries:
                extra += f"  retries {it.retries}"
                if it.retry_wait_s > 0:
                    extra += f" (wait {it.retry_wait_s:.3f}s)"
            lines.append(
                f"    [{_factor(it):>16}] {it.kind} {it.node}->{it.peer}"
                f"   start {it.start - rep.t0:8.3f}  dur {it.dur:8.3f}"
                f"  ({share:4.1f}%){extra}"
            )
        gate_share = 100.0 * rep.gate.dur / span
        lines.append(
            f"  gated by: node {rep.gate_node} "
            f"(factor {rep.gate_factor}"
            + (f", straggle x{rep.gate.straggle:g}"
               if rep.gate.straggle > 1.0 else "")
            + f") — {gate_share:.1f}% of the round"
        )
        if rep.slack:
            lines.append(
                f"  slack: {len(rep.slack)} off-path item(s) finished "
                f"{rep.slack[0]:.3f}–{rep.slack[-1]:.3f}s before round end "
                f"(median {median(rep.slack):.3f}s)"
            )
    return "\n".join(lines)
