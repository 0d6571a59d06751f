"""Metrics registry for the EECC telemetry plane.

The port's own copy of ``repro.obs.metrics`` (numpy and the standard library
only); the two must stay identical in behaviour, which
``tests/test_torch_sim.py`` holds them to.

A :class:`MetricsRegistry` holds named counter / gauge / histogram series,
optionally labeled (``reg.counter("sim_link_bytes_total", link="end-edge")``).
Series are created on first touch and identified by ``name{labels}``; a name
is bound to one metric type for the registry's lifetime.

Naming conventions (see ``docs/observability.md``):

  sim_*      discrete-event scheduler quantities (one registry per SimEngine)
  fl_*       training-plane quantities (global registry)
  kernel_*   accelerator dispatch quantities (global registry)
  *_total    monotonic counters; *_seconds durations; histograms for
             distributions, gauges for last-written values.

Exports: :meth:`MetricsRegistry.snapshot` (JSON-safe dict, round-trips
through ``json``), :meth:`MetricsRegistry.to_prometheus` (text exposition
format), :meth:`MetricsRegistry.to_json`.

The module-level :func:`global_registry` collects process-wide series that
have no natural owner (eval wall time, kernel dispatch latency); the sim
engine keeps its own registry per run so replays start from zero.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_left
from typing import Iterable

# Decade-ish bounds covering microseconds..minutes; +Inf is implicit.
DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 60.0)


def series_key(name: str, labels: dict[str, str]) -> str:
    """Canonical ``name{k="v",...}`` series identifier (sorted labels)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n

    def dump(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value."""

    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dump(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket distribution with sum/count/min/max."""

    kind = "histogram"

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)  # last slot = +Inf
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        # first bucket with bound >= v, i.e. the linear "v <= b" scan;
        # bisect because the sim observes queue depth once per instant
        self.counts[bisect_left(self.bounds, v)] += 1

    def dump(self) -> dict:
        out = {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "buckets": {
                **{repr(b): c for b, c in zip(self.bounds, self.counts)},
                "+Inf": self.counts[-1],
            },
        }
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
        return out


class MetricsRegistry:
    def __init__(self):
        self._series: dict[str, object] = {}  # series_key -> metric
        self._types: dict[str, str] = {}  # base name -> kind

    # -- series accessors (create on first touch) ---------------------------

    def _get(self, cls, name: str, labels: dict[str, str], **kw):
        kind = self._types.setdefault(name, cls.kind)
        if kind != cls.kind:
            raise TypeError(
                f"metric {name!r} already registered as a {kind}, "
                f"not a {cls.kind}"
            )
        key = series_key(name, labels)
        m = self._series.get(key)
        if m is None:
            m = self._series[key] = cls(**kw)
        return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: Iterable[float] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    # -- introspection ------------------------------------------------------

    def names(self) -> list[str]:
        """Sorted base metric names (label-blind) — the stability contract
        gated by ``benchmarks.run --check-obs``."""
        return sorted(self._types)

    def snapshot(self) -> dict[str, dict]:
        """JSON-safe ``{series_key: dump}`` — round-trips bit-identically
        through ``json.dumps``/``loads``."""
        return {k: self._series[k].dump() for k in sorted(self._series)}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one ``# TYPE`` per family)."""
        by_name: dict[str, list[tuple[str, object]]] = {}
        for key, m in sorted(self._series.items()):
            base = key.split("{", 1)[0]
            by_name.setdefault(base, []).append((key, m))
        lines: list[str] = []
        for base in sorted(by_name):
            lines.append(f"# TYPE {base} {self._types[base]}")
            for key, m in by_name[base]:
                if isinstance(m, Histogram):
                    labels = key[len(base):]  # "" or "{...}"
                    inner = labels[1:-1] if labels else ""
                    cum = 0
                    for b, c in zip(m.bounds, m.counts):
                        cum += c
                        le = f'le="{b:g}"'
                        lab = f"{{{inner},{le}}}" if inner else f"{{{le}}}"
                        lines.append(f"{base}_bucket{lab} {cum}")
                    cum += m.counts[-1]
                    le = 'le="+Inf"'
                    lab = f"{{{inner},{le}}}" if inner else f"{{{le}}}"
                    lines.append(f"{base}_bucket{lab} {cum}")
                    lines.append(f"{base}_sum{labels} {m.sum:g}")
                    lines.append(f"{base}_count{labels} {m.count}")
                else:
                    lines.append(f"{key} {m.value:g}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Process-wide registry
# ---------------------------------------------------------------------------

_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
