"""Discrete-event EEC-NET simulator of the PyTorch port, counterpart of
``repro.sim`` (paper §IV-E "migration-resilient" claims made measurable).

Layers:
  * ``events``    — deterministic event queue + structured event log.
  * ``network``   — per-tier link latency/bandwidth models.
  * ``churn``     — node lifecycle (dropout/rejoin), stragglers, mobility.
  * ``faults``    — seeded fault injection: lossy transfers with
                    retry/backoff, link flaps, regional outages,
                    departures, byzantine label noise.
  * ``scenarios`` — ``ScenarioConfig`` + named scenario registry.
  * ``engine``    — event-driven rounds over any ``FLAlgorithm``'s work
                    items (``repro_torch.fl.api``): BSBODP pairs for FedEEC.
  * ``runner``    — CLI: ``python -m repro_torch.sim.runner --scenario ...``.

Everything here is host numpy and the standard library; only the
trainer's ``execute`` touches the card. The event log is bit-identical to
the reference's for the same (scenario, seed, trainer schedule).
"""
from repro_torch.sim.events import Event, EventLog, EventQueue  # noqa: F401
from repro_torch.sim.faults import (  # noqa: F401
    FAULT_PLANS,
    FaultPlan,
    FaultProcess,
    get_fault_plan,
    list_fault_plans,
    register_fault_plan,
)
from repro_torch.sim.network import LinkSpec, NetworkModel  # noqa: F401
from repro_torch.sim.scenarios import (  # noqa: F401
    SCENARIOS,
    ScenarioConfig,
    get_scenario,
    list_scenarios,
    register_scenario,
)
from repro_torch.sim.engine import SimEngine  # noqa: F401
