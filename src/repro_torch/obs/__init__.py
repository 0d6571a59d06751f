"""Telemetry plane of the PyTorch port, counterpart of ``repro.obs``.

  metrics.py        counter/gauge/histogram registry -> JSON / Prometheus

The simulator keeps one registry per run, outside its event log. The
tracer, the critical-path attribution and the report CLI come with the
port's tracing slice (ROADMAP.md, A5).
"""
from repro_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    global_registry,
)
