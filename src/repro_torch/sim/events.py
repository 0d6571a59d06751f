"""Deterministic discrete-event machinery.

The port's own copy of ``repro.sim.events`` (numpy and the standard library
only); the two must stay identical in behaviour, which
``tests/test_torch_sim.py`` holds them to.

The queue is a calendar queue keyed on ``(time, seq)`` where ``seq`` is
a monotonically increasing insertion counter: events land in an exact
same-instant bucket (a plain list, so a bucket is always in insertion
order), and a binary heap over the *distinct* bucket times serves as the
sparse-tail fallback. Dense instants — thousands of items enabled at one
round boundary — pop as ONE ``pop_batch`` in O(1) per event instead of
O(log n) heap sifts; a sparse schedule with all-distinct times degrades
gracefully to exactly the old heap behavior. Either way two events at
the same simulated instant always pop in insertion order, so a run is a
pure function of (scenario, seed) and can be replayed bit-for-bit.

The log keeps one flat dict per event (JSON-serializable); its
``signature()`` is a stable hash used by the determinism tests and by
``runner.py --verify`` to prove replays are identical.

Every entry additionally carries ``ord`` — a monotonic append counter
that totally orders the log, including same-instant ``note`` entries
(whose legacy ``seq`` is the constant ``-1``: notes never pass through
the queue). ``ord`` exists for trace reconstruction
(``repro.obs.critical_path``; the port's comes with its tracing slice)
and is EXCLUDED from ``signature()``, so
tracked signatures in ``benchmarks/tables/scenarios.json`` are unchanged
by its introduction.
"""
from __future__ import annotations

import hashlib
import heapq
import json
from typing import Any, NamedTuple


class Event(NamedTuple):
    """One scheduled occurrence in the simulation.

    A NamedTuple rather than a frozen dataclass: still immutable with
    named fields, but constructed without per-field ``object.__setattr__``
    — the queue creates one per scheduled event, squarely on the
    events/sec hot path.
    """

    time: float
    seq: int
    kind: str  # round_start | pair_start | pair_done | dropout | rejoin |
    #            migrate | straggle | round_end | eval
    node: str = ""
    target: str = ""
    payload: dict = {}  # never mutated; push always passes a fresh dict

    def record(self) -> dict[str, Any]:
        rec = {"t": round(self.time, 6), "seq": self.seq, "kind": self.kind}
        if self.node:
            rec["node"] = self.node
        if self.target:
            rec["target"] = self.target
        if self.payload:
            rec.update(self.payload)
        return rec


#: shared empty payload for events that carry none (never mutated — the
#: queue only ever attaches fresh dicts or caller-owned ones)
_EMPTY: dict = {}


class EventQueue:
    """Calendar queue of events ordered by (time, insertion seq).

    Events at one exact simulated instant share a bucket (a list, so the
    bucket is in ``seq`` order by construction); a min-heap over the
    DISTINCT bucket times orders the instants. Same-instant batches —
    the dense case a round boundary creates at scale — are appends on
    push and one ``pop_batch`` list handoff on pop; a schedule with
    all-distinct times (the sparse tail of a draining round) costs one
    heap sift per instant, exactly the old binary-heap behavior. The
    (time, seq) total order, and hence every event signature, is
    identical to the plain heap's.
    """

    def __init__(self):
        self._buckets: dict[float, list[Event]] = {}
        self._times: list[float] = []  # heap of distinct bucket times
        self._seq = 0
        self._len = 0

    def push(self, time: float, kind: str, node: str = "", target: str = "",
             **payload) -> Event:
        return self.push_payload(time, kind, node, target, payload)

    def push_payload(self, time: float, kind: str, node: str, target: str,
                     payload: dict) -> Event:
        """``push`` without kwargs repacking: ``payload`` is taken by
        reference (the caller must not mutate it afterwards) — the
        engine's event-emission loop calls this tens of thousands of
        times per round."""
        # tuple.__new__ skips Event's generated __new__ (defaults are all
        # supplied here); one less Python frame per scheduled event
        ev = tuple.__new__(
            Event, (time, self._seq, kind, node, target, payload))
        bucket = self._buckets.get(time)
        if bucket is None:
            self._buckets[time] = [ev]
            heapq.heappush(self._times, time)
        else:
            bucket.append(ev)
        self._seq += 1
        self._len += 1
        return ev

    def push_pair(self, t0: float, t1: float, node: str, target: str,
                  payload: dict) -> None:
        """Fast-path fusion: push a ``pair_start`` at ``t0`` and a
        ``pair_done`` at ``t1`` for the same (node, target) in one call.
        Seq assignment — and hence the log signature — is identical to
        two consecutive :meth:`push_payload` calls; fusing halves the
        call count of the engine's per-item emission loop."""
        buckets = self._buckets
        times = self._times
        seq = self._seq
        ev = tuple.__new__(
            Event, (t0, seq, "pair_start", node, target, _EMPTY))
        b = buckets.get(t0)
        if b is None:
            buckets[t0] = [ev]
            heapq.heappush(times, t0)
        else:
            b.append(ev)
        ev = tuple.__new__(
            Event, (t1, seq + 1, "pair_done", node, target, payload))
        b = buckets.get(t1)
        if b is None:
            buckets[t1] = [ev]
            heapq.heappush(times, t1)
        else:
            b.append(ev)
        self._seq = seq + 2
        self._len += 2

    def pop(self) -> Event:
        t = self._times[0]
        bucket = self._buckets[t]
        ev = bucket.pop(0)
        if not bucket:
            heapq.heappop(self._times)
            del self._buckets[t]
        self._len -= 1
        return ev

    def pop_batch(self) -> list[Event]:
        """Remove and return ALL events at the earliest queued instant,
        in insertion (= seq) order. O(1) per event."""
        t = heapq.heappop(self._times)
        batch = self._buckets.pop(t)
        self._len -= len(batch)
        return batch

    def peek_time(self) -> float:
        """Time of the earliest queued event (queue must be non-empty)."""
        return self._times[0]

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0


class EventLog:
    """Append-only structured log of everything the simulator did."""

    def __init__(self):
        self.entries: list[dict] = []
        self._ord = 0  # monotonic append counter (see module docstring)

    def _stamp(self, rec: dict) -> None:
        rec["ord"] = self._ord
        self._ord += 1
        self.entries.append(rec)

    def append(self, ev: Event) -> None:
        # Event.record() + _stamp(), inlined: this runs once per simulated
        # event and the two extra frames are measurable at 10^5 events/s
        rec = {"t": round(ev.time, 6), "seq": ev.seq, "kind": ev.kind}
        if ev.node:
            rec["node"] = ev.node
        if ev.target:
            rec["target"] = ev.target
        if ev.payload:
            rec.update(ev.payload)
        rec["ord"] = self._ord
        self._ord += 1
        self.entries.append(rec)

    def append_batch(self, evs: list[Event]) -> None:
        """Append a same-instant batch (one ``pop_batch`` result) in
        order. Identical entries to per-event :meth:`append`, with the
        shared timestamp rounded once and one call for the whole batch —
        the drain loop hands over every instant this way."""
        entries = self.entries
        o = self._ord
        rt = round(evs[0].time, 6)
        for ev in evs:
            rec = {"t": rt, "seq": ev.seq, "kind": ev.kind}
            if ev.node:
                rec["node"] = ev.node
            if ev.target:
                rec["target"] = ev.target
            if ev.payload:
                rec.update(ev.payload)
            rec["ord"] = o
            o += 1
            entries.append(rec)
        self._ord = o

    def note(self, time: float, kind: str, **fields) -> None:
        rec = {"t": round(time, 6), "seq": -1, "kind": kind}
        rec.update(fields)
        self._stamp(rec)

    def count(self, kind: str) -> int:
        return sum(1 for e in self.entries if e["kind"] == kind)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.entries:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return dict(sorted(out.items()))

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.entries, f, indent=1)

    def signature(self) -> str:
        """Stable content hash — identical across replays of the same
        (scenario, seed); rounding in ``Event.record`` absorbs float fuzz.
        The ``ord`` append counter is excluded so the hash is byte-for-byte
        what pre-``ord`` logs produced (the scenarios.json gate)."""
        blob = json.dumps(
            [{k: v for k, v in e.items() if k != "ord"}
             for e in self.entries],
            sort_keys=True,
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]
