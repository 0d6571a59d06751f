"""Telemetry plane of the PyTorch port, counterpart of ``repro.obs``.

  trace.py          hierarchical spans -> Chrome trace JSON (Perfetto)
  metrics.py        counter/gauge/histogram registry -> JSON / Prometheus
  critical_path.py  per-round gating attribution from logs or traces
  report.py         `python -m repro_torch.obs.report` CLI

Instrumentation is a single ``None`` check when tracing is off and never
touches the simulator's event log: signatures and ``ord``s are identical
with tracing on and off. The Chrome trace JSON is the reference's format,
so each package's report reads the other's traces.
"""
from repro_torch.obs.critical_path import (  # noqa: F401
    explain,
    rounds_from_eventlog,
    rounds_from_trace,
)
from repro_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    global_registry,
)
from repro_torch.obs.trace import (  # noqa: F401
    Tracer,
    active_tracer,
    set_active_tracer,
    tracing,
)
