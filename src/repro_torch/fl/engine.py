"""FL experiment engine, counterpart of ``repro.fl.engine``: builds the
dataset / partition / topology / autoencoder, runs the selected algorithm
for R rounds, and records the cloud-model accuracy curve and the
communication bytes (the quantities behind paper Tables III-VII and Fig. 5).

With a ``scenario`` (name or ``ScenarioConfig``), rounds run inside the
discrete-event EEC-NET simulator (``repro_torch.sim``): churn fires at
round boundaries, pair work is priced by link bandwidth/latency, faults are
injected, and the accuracy curve is reported against simulated seconds;
there the run can snapshot itself every N rounds and resume from a
snapshot (the port's or the reference's), bit-identically. A ``tracer``
records the run's spans on either path (``repro_torch.obs``).

Everything runs on ``device``, which defaults to ``"cuda"`` and raises
without a card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.topology import Tree
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.api import create_algorithm, list_algorithms  # noqa: F401  (re-export)
from repro_torch.fl.metrics import accuracy
from repro_torch.models.autoencoder import pretrain_autoencoder
from repro_torch.obs.trace import tracing


@dataclass
class RunResult:
    algorithm: str
    cfg: FLConfig
    acc_curve: list[float] = field(default_factory=list)
    best_acc: float = 0.0
    comm_bytes: dict[str, float] = field(default_factory=dict)
    wall_s: float = 0.0
    # host seconds of each round's training, ending in a device sync
    # (on the scenario path: churn and items; outside the event log)
    round_s: list[float] = field(default_factory=list)
    # simulated-network quantities (set when a scenario drives the run)
    scenario: str = ""
    sim_times: list[float] = field(default_factory=list)  # seconds per eval
    sim_wall_s: float = 0.0  # simulated length of the whole run
    event_counts: dict[str, int] = field(default_factory=dict)
    event_log: list[dict] = field(default_factory=list)
    event_signature: str = ""
    # metrics-registry snapshot of the run (repro_torch.obs.metrics),
    # outside the event log
    metrics: dict[str, dict] = field(default_factory=dict)

    @property
    def final_acc(self) -> float:
        return self.acc_curve[-1] if self.acc_curve else 0.0

    @property
    def dispatch_stats(self) -> dict[str, int]:
        """Pair-coalescing counters, a view over ``metrics``."""
        def val(name: str) -> int:
            return int(self.metrics.get(name, {}).get("value", 0))
        return {
            "items": val("sim_dispatch_items_total"),
            "dispatches": val("sim_dispatches_total"),
            "batched_dispatches": val("sim_batched_dispatches_total"),
            "batched_items": val("sim_batched_items_total"),
        }

    @property
    def sim_curve(self) -> list[tuple[float, float]]:
        """(simulated seconds, accuracy) points."""
        return list(zip(self.sim_times, self.acc_curve))


# LRU of pre-trained autoencoders: parameter sweeps cycle through many
# (dataset, image, embed_dim, seed) combos; keep only the hottest few alive
_AUTO_CACHE: OrderedDict = OrderedDict()
_AUTO_CACHE_MAX = 4


def _pretrained_auto(cfg: FLConfig, x_open, device: torch.device):
    """The frozen autoencoder depends only on the open split — cache it
    per (dataset, image, embed_dim, seed, device) within the process."""
    key = (cfg.dataset, cfg.image_size, cfg.embed_dim, cfg.seed, str(device))
    if key in _AUTO_CACHE:
        _AUTO_CACHE.move_to_end(key)
        return _AUTO_CACHE[key]
    auto = pretrain_autoencoder(
        cfg.seed + 7,
        x_open,
        image=cfg.image_size,
        embed_dim=cfg.embed_dim,
        device=device,
    )
    _AUTO_CACHE[key] = auto
    while len(_AUTO_CACHE) > _AUTO_CACHE_MAX:
        _AUTO_CACHE.popitem(last=False)
    return auto


def build_problem(cfg: FLConfig, *, device="cuda"):
    """dataset + dirichlet partition + tree + pre-trained autoencoder."""
    dev = resolve_device(device)
    ds = make_dataset(
        cfg.dataset,
        num_train=cfg.num_clients * cfg.samples_per_client,
        num_test=cfg.test_samples,
        image=cfg.image_size,
        num_classes=cfg.num_classes,
        seed=cfg.seed,
    )
    parts = dirichlet_partition(
        ds.y_train, cfg.num_clients, cfg.dirichlet_alpha, seed=cfg.seed
    )
    tree = Tree.three_tier(cfg.num_edges, cfg.num_clients)
    client_data = {
        f"client{i}": (ds.x_train[parts[i]], ds.y_train[parts[i]])
        for i in range(cfg.num_clients)
    }
    auto = _pretrained_auto(cfg, ds.x_open, dev)
    return ds, tree, client_data, auto


def make_trainer(algorithm: str, cfg: FLConfig, tree, client_data, auto, *,
                 device="cuda"):
    """Deprecated: resolve algorithm names through the registry instead.

    Kept as a shim so pre-registry callers keep working;
    ``repro_torch.fl.api.create_algorithm`` is the real API.
    """
    warnings.warn(
        "make_trainer is deprecated; use repro_torch.fl.api.create_algorithm "
        "(or @register_algorithm for new algorithms)",
        DeprecationWarning, stacklevel=2,
    )
    return create_algorithm(algorithm, cfg, tree, client_data, auto, device=device)


def run_experiment(
    algorithm: str,
    cfg: FLConfig,
    *,
    rounds: int | None = None,
    eval_every: int = 1,
    verbose: bool = False,
    migration_round: int | None = None,
    scenario=None,
    tracer=None,
    faults=None,
    checkpoint_every: int = 0,
    checkpoint_dir: str = "",
    resume_from: str = "",
    stop_after: int | None = None,
    profile_sim: bool = False,
    device="cuda",
) -> RunResult:
    """Run ``algorithm`` for R rounds on ``device``.

    ``scenario`` (a name from ``repro_torch.sim.scenarios`` or a
    ``ScenarioConfig``; falls back to ``cfg.scenario``) switches to the
    event-driven simulated-network path. ``faults`` (a ``FaultPlan`` or
    plan name, scenario path only) overrides the scenario's plan; byzantine
    plans rewrite client labels BEFORE trainer construction, so FedEEC's
    embedding stores see the noise. ``checkpoint_every`` /
    ``checkpoint_dir`` snapshot the engine every N rounds; ``resume_from``
    restores a snapshot and continues, bit-identical to an uninterrupted
    run; ``stop_after`` ends the run early (simulating a kill, no final
    eval). These four act on the scenario path only; the plain path
    ignores them, as the reference's does. ``profile_sim`` records the
    simulator's host phase times as gauges in ``metrics``. ``tracer`` (a
    ``repro_torch.obs.trace.Tracer``) records hierarchical spans of the
    run: it is installed as the active tracer, so the plain round's
    ``execute`` spans and the kernel ops' ``kernel.*`` spans nest too.
    """
    dev = resolve_device(device)

    scenario = scenario if scenario is not None else (cfg.scenario or None)
    sc = None
    if scenario is not None:
        from repro_torch.sim.scenarios import get_scenario

        sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if isinstance(faults, str):
        from repro_torch.sim.faults import get_fault_plan

        faults = get_fault_plan(faults)
    plan = faults if faults is not None else (
        sc.faults if sc is not None else None)

    ds, tree, client_data, auto = build_problem(cfg, device=dev)
    if plan is not None and plan.label_noise_frac > 0:
        from repro_torch.sim.faults import apply_label_noise

        client_data, _ = apply_label_noise(
            plan, client_data, cfg.seed, cfg.num_classes)
    trainer = create_algorithm(algorithm, cfg, tree, client_data, auto,
                               device=dev)
    rounds = rounds if rounds is not None else cfg.rounds
    res = RunResult(algorithm, cfg)
    t0 = time.perf_counter()  # analysis: allow[DET001] host-only wall_s, not in event log
    with tracing(tracer):
        if sc is not None:
            _run_simulated(trainer, sc, cfg, ds, res, rounds, eval_every,
                           verbose, dev, tracer, faults=faults,
                           checkpoint_every=checkpoint_every,
                           checkpoint_dir=checkpoint_dir,
                           resume_from=resume_from, stop_after=stop_after,
                           profile_sim=profile_sim)
        else:
            _run_plain(trainer, ds, res, rounds, eval_every, verbose,
                       migration_round, dev)
    res.comm_bytes = trainer.comm.summary()
    res.wall_s = time.perf_counter() - t0  # analysis: allow[DET001]
    return res


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_plain(trainer, ds, res, rounds, eval_every, verbose,
               migration_round, dev):
    for r in range(rounds):
        if migration_round is not None and r == migration_round:
            # move one client to a different edge mid-training (§IV-E demo)
            leaf = trainer.tree.leaves[0]
            edges = [v for v in trainer.tree.nodes
                     if not trainer.tree.is_leaf(v) and v != trainer.tree.root]
            cur = trainer.tree.parent[leaf]
            target = next((e for e in edges if e != cur), None)
            if target is None:
                warnings.warn(
                    "migration demo skipped: needs >= 2 edges "
                    f"(topology has {len(edges)})", stacklevel=2,
                )
            elif not trainer.try_migrate(leaf, target):
                warnings.warn(
                    f"migration demo refused by protocol "
                    f"{trainer.protocol.name!r}: {leaf} -/-> {target}",
                    stacklevel=2,
                )
        t0 = time.perf_counter()  # analysis: allow[DET001] host-only round_s, not in event log
        trainer.train_round()
        _sync(dev)
        res.round_s.append(time.perf_counter() - t0)  # analysis: allow[DET001]
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            acc = accuracy(trainer.cloud_apply(), trainer.cloud_params(),
                           ds.x_test, ds.y_test)
            res.acc_curve.append(acc)
            res.best_acc = max(res.best_acc, acc)
            if verbose:
                print(f"  [{res.algorithm}] round {r+1:3d}  cloud acc {acc:.4f}", flush=True)


def _run_simulated(trainer, sc, cfg, ds, res, rounds, eval_every, verbose,
                   dev, tracer=None, *, faults=None, checkpoint_every=0,
                   checkpoint_dir="", resume_from="", stop_after=None,
                   profile_sim=False):
    from repro_torch.sim.engine import SimEngine

    engine = SimEngine(trainer, sc, seed=cfg.seed, tracer=tracer,
                       faults=faults, profile=profile_sim)
    if resume_from:
        engine.restore_checkpoint(resume_from)

    def eval_fn():
        return accuracy(trainer.cloud_apply(), trainer.cloud_params(),
                        ds.x_test, ds.y_test)

    log = engine.run(rounds, eval_fn=eval_fn, eval_every=eval_every,
                     checkpoint_every=checkpoint_every,
                     checkpoint_path=checkpoint_dir, stop_after=stop_after,
                     sync=lambda: _sync(dev))
    res.scenario = sc.name
    res.round_s = list(engine.round_s)
    for t, acc in engine.acc_points:
        res.sim_times.append(t)
        res.acc_curve.append(acc)
        res.best_acc = max(res.best_acc, acc)
        if verbose:
            print(f"  [{res.algorithm}/{sc.name}] sim t={t:8.1f}s "
                  f"cloud acc {acc:.4f}", flush=True)
    res.sim_wall_s = engine.now
    res.event_counts = log.counts()
    res.event_log = log.entries
    res.event_signature = log.signature()
    res.metrics = engine.metrics.snapshot()
