"""Hierarchical tracing for the EECC stack, the port's own copy of
``repro.obs.trace`` (the standard library only).

A :class:`Tracer` records a tree of spans — round → churn → dispatch group
→ work item → kernel call — each carrying host wall time (``perf_counter``)
and, where the simulator knows it, simulated time. Recording is append-only
into plain lists; when no tracer is installed every instrumentation site is
a single ``None`` check (see :func:`active_tracer`), so tracing-off runs
add no measurable overhead and NEVER touch the event log (the
``scenarios.json`` signature gate stays bit-identical either way).

Two kinds of span:

* **lived** spans (:meth:`Tracer.span`): a context manager timing a host
  code block (dispatch groups, kernel calls, eval);
* **computed** spans (:meth:`Tracer.add_span`): simulated-time intervals
  the scheduler derives rather than lives through (work items: the sim
  start/end the event queue will replay).

Export (:meth:`Tracer.to_chrome` / :meth:`Tracer.to_json`) is Chrome
trace-event JSON, openable directly in Perfetto / chrome://tracing. The
simulated timeline is process "sim" with one track row per node (cloud /
edges / clients sorted top-down) plus a scheduler row; host-only spans land
on process "host". Span args carry the cross-links (``span``/``parent``
ids, host duration on sim spans). The export is byte-compatible with the
reference's (the same pids, tids, phases and arg keys), so either
package's ``report`` reads the other's files.

On a card, host wall time is host time: a span around a kernel op times
its dispatch (and any sync the op makes), not the kernel's device time.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

SIM_PID = 1  # simulated-time timeline (one row per node)
HOST_PID = 2  # host wall-clock timeline


@dataclass
class Span:
    sid: int
    parent: int  # -1 = root
    name: str
    cat: str = ""
    node: str = ""  # sim track row; "" -> scheduler row
    t0_host: float = 0.0  # perf_counter seconds (tracer origin-relative)
    t1_host: float = 0.0
    sim_t0: Optional[float] = None
    sim_t1: Optional[float] = None
    args: dict = field(default_factory=dict)

    @property
    def host_dur(self) -> float:
        return self.t1_host - self.t0_host


class Tracer:
    def __init__(self):
        self.spans: list[Span] = []
        self.instants: list[dict] = []
        self._origin = time.perf_counter()
        self._stack: list[int] = []

    # -- recording ----------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._origin

    @contextmanager
    def span(self, name: str, *, cat: str = "", node: str = "",
             sim_t0: Optional[float] = None, **args):
        """Time a host code block as a span nested under the current one.
        Yields the :class:`Span`; callers may set ``sim_t1``/``args`` on it
        before the block exits."""
        sp = Span(
            sid=len(self.spans),
            parent=self._stack[-1] if self._stack else -1,
            name=name, cat=cat, node=node, sim_t0=sim_t0,
            t0_host=self._now(), args=dict(args),
        )
        self.spans.append(sp)
        self._stack.append(sp.sid)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.t1_host = self._now()

    def add_span(self, name: str, *, sim_t0: float, sim_t1: float,
                 cat: str = "", node: str = "", host_dur: float = 0.0,
                 **args) -> Span:
        """Record a computed simulated-time interval (no host block is
        lived); parented under the currently open span."""
        t = self._now()
        sp = Span(
            sid=len(self.spans),
            parent=self._stack[-1] if self._stack else -1,
            name=name, cat=cat, node=node,
            t0_host=t, t1_host=t + host_dur,
            sim_t0=sim_t0, sim_t1=sim_t1, args=dict(args),
        )
        self.spans.append(sp)
        return sp

    def instant(self, name: str, *, sim_t: Optional[float] = None,
                node: str = "", **args) -> None:
        self.instants.append({
            "name": name, "node": node, "sim_t": sim_t,
            "host_t": self._now(), "args": dict(args),
        })

    # -- export -------------------------------------------------------------

    def _sim_tids(self) -> dict[str, int]:
        nodes = sorted(
            {sp.node for sp in self.spans if sp.node}
            | {i["node"] for i in self.instants if i["node"]}
        )
        # scheduler row first, then nodes (cloud/edge/client sort adjacently)
        return {"": 0, **{n: i + 1 for i, n in enumerate(nodes)}}

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (the ``traceEvents`` container format)
        — drop the file on https://ui.perfetto.dev and every sim node is a
        track row on the simulated-time axis."""
        tids = self._sim_tids()
        ev: list[dict] = [
            {"ph": "M", "pid": SIM_PID, "tid": 0, "name": "process_name",
             "args": {"name": "sim (simulated time)"}},
            {"ph": "M", "pid": HOST_PID, "tid": 0, "name": "process_name",
             "args": {"name": "host (wall clock)"}},
            {"ph": "M", "pid": HOST_PID, "tid": 0, "name": "thread_name",
             "args": {"name": "host"}},
        ]
        for node, tid in tids.items():
            ev.append({"ph": "M", "pid": SIM_PID, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": node or "scheduler"}})
        for sp in self.spans:
            args = {"span": sp.sid, "parent": sp.parent, **sp.args}
            if sp.node:
                args.setdefault("node", sp.node)
            if sp.sim_t0 is not None and sp.sim_t1 is not None:
                args["host_dur_us"] = round(sp.host_dur * 1e6, 1)
                ev.append({
                    "ph": "X", "pid": SIM_PID, "tid": tids[sp.node],
                    "name": sp.name, "cat": sp.cat or "sim",
                    "ts": round(sp.sim_t0 * 1e6, 3),
                    "dur": round((sp.sim_t1 - sp.sim_t0) * 1e6, 3),
                    "args": args,
                })
            else:
                if sp.sim_t0 is not None:
                    args["sim_t0"] = sp.sim_t0
                ev.append({
                    "ph": "X", "pid": HOST_PID, "tid": 0,
                    "name": sp.name, "cat": sp.cat or "host",
                    "ts": round(sp.t0_host * 1e6, 3),
                    "dur": round(sp.host_dur * 1e6, 3),
                    "args": args,
                })
        for ins in self.instants:
            on_sim = ins["sim_t"] is not None
            ev.append({
                "ph": "i", "s": "t",
                "pid": SIM_PID if on_sim else HOST_PID,
                "tid": tids[ins["node"]] if on_sim else 0,
                "name": ins["name"],
                "ts": round((ins["sim_t"] if on_sim else ins["host_t"]) * 1e6, 3),
                "args": ins["args"],
            })
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")


# ---------------------------------------------------------------------------
# Active-tracer plumbing (zero overhead when off)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None


def active_tracer() -> Optional[Tracer]:
    """The installed tracer, or None. Instrumentation sites branch on this
    — one global read + ``is None`` when tracing is off."""
    return _ACTIVE


def set_active_tracer(tr: Optional[Tracer]) -> Optional[Tracer]:
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tr
    return prev


@contextmanager
def tracing(tr: Optional[Tracer]):
    """Install ``tr`` as the active tracer for a ``with`` block."""
    prev = set_active_tracer(tr)
    try:
        yield tr
    finally:
        set_active_tracer(prev)
