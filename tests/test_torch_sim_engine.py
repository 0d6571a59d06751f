"""The port's simulator engine against the tracked records the JAX package
wrote: the event signatures of ``benchmarks/tables/scenarios.json``, the
fault counters of ``BENCH_faults.json`` and the scheduler tiers of
``BENCH_sim.json``, read as JSON.

The FedEEC runs are built as the table's generator builds them (4 clients,
2 edges, 2 rounds, cnn2 edge and cloud, eval off) on the CPU, with the
trainer's coalesced dispatch, as the table's were written. Under faults,
forced serial dispatch (``batch_signature`` -> ``None``) draws the transfer
outcomes in another item order and gives another ``fedeec/lossy_links``
signature (ROADMAP.md C9, fixed):
``test_lossy_links_serial_signature_is_the_references`` pins both against
the JAX package.
"""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.configs.fedeec_paper import paper_setting
from repro_torch.core.topology import Tree
from repro_torch.fl.api import FLAlgorithm, WorkItem, create_algorithm
from repro_torch.fl.engine import build_problem
from repro_torch.sim.engine import SimEngine
from repro_torch.sim.scenarios import ScenarioConfig, get_scenario, list_scenarios

ROOT = Path(__file__).resolve().parent.parent
TABLE = json.loads((ROOT / "benchmarks" / "tables" / "scenarios.json").read_text())
BENCH_FAULTS = json.loads((ROOT / "BENCH_faults.json").read_text())
BENCH_SIM = json.loads((ROOT / "BENCH_sim.json").read_text())["tiers"]
# the reference's signature with forced serial dispatch where the table's
# (coalesced dispatch) differs
SERIAL_DISPATCH = {"fedeec/lossy_links": "a777706636504be1"}
GATE = dict(samples_per_client=16, test_samples=64, image_size=8, embed_dim=16,
            edge_model="cnn2", cloud_model="cnn2")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite's workers share the machine's cores, and torch's default
    of one intra-op thread per core then oversubscribes them many times
    over (a CPU FedEEC run here slowed thirtyfold): two threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def gate_engine(name: str, serial: bool = False, algorithm: str = "fedeec",
                **engine_kw) -> SimEngine:
    """Two rounds of ``algorithm`` (FedEEC by default) through scenario
    ``name``, no eval; ``serial`` forces serial dispatch."""
    cfg = paper_setting("synth_cifar10", 4, 2, **GATE)
    _, tree, client_data, auto = build_problem(cfg, device="cpu")
    trainer = create_algorithm(algorithm, cfg, tree, client_data, auto, device="cpu")
    if serial:
        trainer.batch_signature = lambda item: None
    engine = SimEngine(trainer, get_scenario(name), seed=cfg.seed, **engine_kw)
    engine.run(2)
    return engine


def test_the_table_names_every_scenario():
    assert sorted(k[len("fedeec/"):] for k in TABLE if k.startswith("fedeec/")) \
        == list_scenarios()


@pytest.mark.parametrize("name", list_scenarios())
def test_fedeec_signature_matches_the_table(name):
    key = f"fedeec/{name}"
    engine = gate_engine(name)
    assert engine.log.signature() == TABLE[key]
    stats = engine.dispatch_stats
    assert stats["dispatches"] == stats["items"] - stats["batched_items"] \
        + stats["batched_dispatches"] > 0


@pytest.mark.parametrize("name", list_scenarios())
def test_hierfavg_signature_matches_the_table(name):
    """The baselines keep serial dispatch, as the reference's do: every
    item runs alone."""
    engine = gate_engine(name, algorithm="hierfavg")
    assert engine.log.signature() == TABLE[f"hierfavg/{name}"]
    stats = engine.dispatch_stats
    assert stats["dispatches"] == stats["items"] > 0 and stats["batched_dispatches"] == 0


@pytest.mark.parametrize("name", sorted(BENCH_FAULTS))
def test_fault_counters_match_bench_faults(name):
    want = BENCH_FAULTS[name]
    engine = gate_engine(name)
    assert engine.fault_plan.name == want["fault_plan"]
    snap = engine.metrics.snapshot()
    for counter, n in want.items():
        if counter.startswith("sim_"):
            assert int(snap.get(counter, {}).get("value", 0)) == n, counter
    assert engine.log.signature() == want["signature"]
    lost = snap["sim_pairs_abandoned_total"]["value"] + snap["sim_pair_timeouts_total"]["value"]
    assert len(engine.trainer.failed_pairs) == lost


def test_lossy_links_serial_signature_is_the_references(monkeypatch):
    """ROADMAP.md C9: forced serial dispatch gives the JAX package and the
    port one signature, and their coalesced dispatch the table's. The
    schedule does not depend on the autoencoder's values, so the JAX run
    skips its pretrain."""
    import jax

    import repro.fl.engine as jengine
    from repro.configs.fedeec_paper import paper_setting as j_paper_setting
    from repro.models.autoencoder import init_autoencoder
    from repro.sim.engine import SimEngine as JSimEngine
    from repro.sim.scenarios import get_scenario as j_get_scenario

    monkeypatch.setattr(jengine, "_pretrained_auto", lambda cfg, x: init_autoencoder(
        jax.random.PRNGKey(0), image=cfg.image_size, embed_dim=cfg.embed_dim))
    cfg = j_paper_setting("synth_cifar10", 4, 2, **GATE)
    sigs = {}
    for serial in (True, False):
        _, tree, client_data, auto = jengine.build_problem(cfg)
        trainer = jengine.create_algorithm("fedeec", cfg, tree, client_data, auto)
        if serial:
            trainer.batch_signature = lambda item: None
        engine = JSimEngine(trainer, j_get_scenario("lossy_links"), seed=cfg.seed)
        sigs[serial] = engine.run(2).signature()
    assert sigs[True] == SERIAL_DISPATCH["fedeec/lossy_links"] == \
        gate_engine("lossy_links", serial=True).log.signature()
    assert sigs[False] == TABLE["fedeec/lossy_links"] != sigs[True]
    assert gate_engine("lossy_links").log.signature() == sigs[False]


def test_tracer_and_checkpoints_raise(tmp_path):
    """A traced engine runs (its round, churn, dispatch, execute and item
    spans recorded outside the log), and the checkpoint calls still round
    trip under it: a snapshot every round, and a second, untraced engine
    restored from it stands where the first one stopped."""
    from repro_torch.obs.trace import Tracer

    cfg = paper_setting("synth_cifar10", 4, 2, **GATE)
    _, tree, client_data, auto = build_problem(cfg, device="cpu")
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device="cpu")
    tracer = Tracer()
    engine = SimEngine(trainer, get_scenario("stable"), tracer=tracer)
    assert engine.tracer is tracer
    ckpt = str(tmp_path / "ckpt")
    engine.run(1, checkpoint_every=1, checkpoint_path=ckpt)
    assert {sp.cat for sp in tracer.spans} >= {"round", "churn", "dispatch", "execute", "item"}
    assert sum(sp.cat == "item" for sp in tracer.spans) == engine.log.count("pair_done") > 0
    assert engine.metrics.counter("sim_checkpoints_total").value == 1
    engine.save_checkpoint(str(tmp_path / "again"))
    _, tree2, cd2, auto2 = build_problem(cfg, device="cpu")
    other = SimEngine(create_algorithm("fedeec", cfg, tree2, cd2, auto2, device="cpu"),
                      get_scenario("stable"))
    other.restore_checkpoint(ckpt)
    assert other.log.entries == engine.log.entries and other.now == engine.now
    assert other.trainer.rng.bit_generator.state == trainer.rng.bit_generator.state
    assert other._round_next == 1


# ----------------------------------------------------------- scheduler tiers

class _NullSim(FLAlgorithm):
    """Pure-scheduling trainer, as ``benchmarks/sim_bench.py`` builds it:
    hierfavg-shaped rounds (one "local" item per client feeding one
    "aggregate" item per edge) with constant comm traffic and no model."""

    def __init__(self, tree: Tree):
        super().__init__(None, tree)
        self._items: list[WorkItem] | None = None

    def work_items(self, round: int, online) -> list[WorkItem]:
        if self._items is None:
            items: list[WorkItem] = []
            root = self.tree.root
            for e in self.tree.children[root]:
                for c in self.tree.children[e]:
                    if self.tree.is_leaf(c):
                        items.append(WorkItem("local", node=c, peer=e,
                                              link=self.link_of(c), steps=5))
                items.append(WorkItem("aggregate", node=e, peer=root,
                                      link=self.link_of(e)))
            self._items = items
        return self._items

    def batch_signature(self, item: WorkItem):
        return ("local", item.steps) if item.kind == "local" else None

    def execute(self, item: WorkItem) -> None:
        self.comm.record(item.link, 1_000, "sync")

    def cloud_params(self):
        return None

    def cloud_apply(self):
        return None


def _bench_scenario(population: int) -> ScenarioConfig:
    return ScenarioConfig(
        "sim_bench",
        "synthetic population-scale tier (unregistered)",
        dropout_prob=0.05,
        dropout_s=(5.0, 30.0),
        straggler_frac=0.1,
        straggler_slowdown=4.0,
        population=population,
    )


@pytest.mark.parametrize("tier", sorted(BENCH_SIM))
def test_scheduler_tier_matches_bench_sim(tier):
    want = BENCH_SIM[tier]
    engine = SimEngine(_NullSim(Tree.three_tier(want["edges"], want["clients"])),
                       _bench_scenario(want["population"]), seed=0)
    engine.run(want["rounds"])
    assert len(engine.log.entries) == want["events_total"]
    assert engine.log.signature() == want["signature"]
    # the null trainer's locals coalesce: the engine's grouping ran, and
    # execute_batch took the serial fallback
    assert engine.dispatch_stats["batched_dispatches"] > 0
