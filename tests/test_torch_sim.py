"""The port's simulator modules against the JAX package's: the same seeds and
calls into both, and the results equal bit for bit (the port keeps its own
numpy copies of ``repro.sim`` and ``repro.obs.metrics``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.topology import Tree as JTree
from repro.obs import metrics as jmetrics
from repro.sim import churn as jchurn
from repro.sim import engine as jengine
from repro.sim import events as jevents
from repro.sim import faults as jfaults
from repro.sim import network as jnetwork
from repro.sim import scenarios as jscenarios
from repro_torch.core.topology import Tree
from repro_torch.fl.api import WorkItem
from repro_torch.obs import metrics as tmetrics
from repro_torch.sim import churn as tchurn
from repro_torch.sim import engine as tengine
from repro_torch.sim import events as tevents
from repro_torch.sim import faults as tfaults
from repro_torch.sim import network as tnetwork
from repro_torch.sim import scenarios as tscenarios


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite's workers share the machine's cores, and torch's default
    of one intra-op thread per core then oversubscribes them many times
    over (a CPU FedEEC run here slowed thirtyfold): two threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _trees(edges=3, clients=12):
    return JTree.three_tier(edges, clients), Tree.three_tier(edges, clients)


def _drive_queue(mod, seed):
    """Pushes at colliding times through every push path, pops by batch and
    one at a time, logs everything: (pop order, log entries, signature)."""
    rng = np.random.default_rng(seed)
    q, log = mod.EventQueue(), mod.EventLog()
    popped = []
    for step in range(40):
        t = float(rng.integers(0, 6)) * 0.25
        k = int(rng.integers(0, 3))
        if k == 0:
            q.push(t, "pair_failed", f"client{step % 5}", "edge0", attempt=step)
        elif k == 1:
            q.push_payload(t, "pair_retried", "edge1", "cloud", {"wait": round(t / 3, 6)})
        else:
            q.push_pair(t, t + 0.5, f"client{step}", "edge2", {"bytes": step * 11.0})
        if step % 7 == 6:
            batch = q.pop_batch()
            log.append_batch(batch)
            popped += [(e.time, e.seq, e.kind) for e in batch]
            log.note(batch[0].time, "idle", reason="x")
    while q:
        e = q.pop()
        log.append(e)
        popped.append((e.time, e.seq, e.kind))
    return popped, log.entries, log.counts(), log.signature()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_queue_and_log_match(seed):
    assert _drive_queue(tevents, seed) == _drive_queue(jevents, seed)


def test_network_model_matches():
    jt, tt = _trees()
    kw = dict(end_edge=jnetwork.DEFAULT_END_EDGE, edge_cloud=jnetwork.DEFAULT_EDGE_CLOUD,
              other=jnetwork.DEFAULT_OTHER, seed=5)
    jn = jnetwork.NetworkModel(jt, **kw)
    tn = tnetwork.NetworkModel(tt, **{**kw, "end_edge": tnetwork.DEFAULT_END_EDGE,
                                      "edge_cloud": tnetwork.DEFAULT_EDGE_CLOUD,
                                      "other": tnetwork.DEFAULT_OTHER})
    nodes = [v for v in jt.nodes if v != jt.root]
    for v in nodes:
        assert tn.speed_factor(v) == jn.speed_factor(v), v
        for nbytes in (0, 1408, 1408.0, 2.5e6):
            a, b = tn.transfer_s(v, nbytes), jn.transfer_s(v, nbytes)
            assert a == b and type(a) is type(b), (v, nbytes)
    for net in (jn, tn):
        net.reset_contention()
    for i, v in enumerate(nodes * 2):
        t = 0.1 * (i % 4)
        assert tn.transfer_shared_s(v, 3000 + i, t) == jn.transfer_shared_s(v, 3000 + i, t)
    # migration invalidates the link cache the same way
    jt.migrate("client0", "edge2")
    tt.migrate("client0", "edge2")
    assert tn.transfer_s("client0", 999) == jn.transfer_s("client0", 999)


def _actions(acts):
    return [dataclasses.astuple(a) for a in acts]


@pytest.mark.parametrize("name", ["mobile_clients", "flaky_edge", "trace_replay"])
def test_churn_rounds_match(name):
    jt, tt = _trees(3, 12)
    jc = jchurn.ChurnProcess(jt, jscenarios.get_scenario(name), seed=2)
    tc = tchurn.ChurnProcess(tt, tscenarios.get_scenario(name), seed=2)
    assert tc.stragglers_sorted == jc.stragglers_sorted
    now = 0.0
    seen = set()
    for r in range(5):
        ja, ta = jc.draw_round(r, now), tc.draw_round(r, now)
        assert _actions(ta) == _actions(ja), r
        seen |= {a.kind for a in ta}
        for a in ja:  # apply the moves, as the engine does
            if a.kind == "migrate" and a.target in jt.nodes and jt.parent[a.node] != a.target:
                jt.migrate(a.node, a.target)
                tt.migrate(a.node, a.target)
        assert tc.offline_map() == jc.offline_map()
        assert tc.online_devices(now) == jc.online_devices(now)
        assert tc.next_rejoin_after(now) == jc.next_rejoin_after(now)
        now += 7.5
    assert tc.rng.bit_generator.state == jc.rng.bit_generator.state
    assert seen, f"{name} drew no churn in 5 rounds"


def test_chaos_faults_match():
    jt, tt = _trees(3, 12)
    jf = jfaults.FaultProcess(jt, jfaults.get_fault_plan("chaos"), seed=4)
    tf = tfaults.FaultProcess(tt, tfaults.get_fault_plan("chaos"), seed=4)
    outcomes = set()
    now = 0.0
    for r in range(4):
        ja = jf.draw_round(r, now, lambda v, t: True)
        ta = tf.draw_round(r, now, lambda v, t: True)
        assert [dataclasses.astuple(a) for a in ta] == [dataclasses.astuple(a) for a in ja]
        for v in [v for v in jt.nodes if v != jt.root]:
            js, ts = jf.plan_attempts(v, now, 0.3), tf.plan_attempts(v, now, 0.3)
            assert dataclasses.astuple(ts) == dataclasses.astuple(js), (r, v)
            outcomes.add(ts.outcome)
            now += 0.2
    assert tf.state() == jf.state()
    assert len(outcomes) > 1, outcomes


def test_label_noise_matches():
    rng = np.random.default_rng(0)
    data = {f"client{i}": (rng.random((9, 2)), rng.integers(0, 10, 9)) for i in range(10)}
    jd, jb = jfaults.apply_label_noise(jfaults.get_fault_plan("byzantine"), data, 3, 10)
    td, tb = tfaults.apply_label_noise(tfaults.get_fault_plan("byzantine"), data, 3, 10)
    assert tb == jb and len(tb) == 3
    for v in data:
        assert np.array_equal(td[v][1], jd[v][1]) and td[v][0] is data[v][0]
    assert any(not np.array_equal(td[v][1], data[v][1]) for v in tb)


def test_registries_match():
    assert tscenarios.list_scenarios() == jscenarios.list_scenarios()
    assert len(tscenarios.list_scenarios()) == 11
    for name in jscenarios.list_scenarios():
        assert dataclasses.asdict(tscenarios.get_scenario(name)) == \
            dataclasses.asdict(jscenarios.get_scenario(name)), name
    assert tfaults.list_fault_plans() == jfaults.list_fault_plans()
    for name in jfaults.list_fault_plans():
        assert dataclasses.asdict(tfaults.get_fault_plan(name)) == \
            dataclasses.asdict(jfaults.get_fault_plan(name)), name
    assert [f.name for f in dataclasses.fields(tscenarios.TraceEntry)] == \
        [f.name for f in dataclasses.fields(jscenarios.TraceEntry)]


def _drive_metrics(mod):
    reg = mod.MetricsRegistry()
    reg.counter("sim_migrations_total").inc()
    reg.counter("sim_link_bytes_total", link="end-edge").inc(1408)
    reg.counter("sim_link_bytes_total", link="edge-cloud").inc(2816.0)
    reg.gauge("sim_straggler_compute_factor", node="client3").set(4.0)
    reg.gauge("sim_events_per_second").inc(2.5)
    h = reg.histogram("sim_queue_depth", buckets=(1, 2, 4, 8))
    for v in (0, 1, 3, 3, 9, 100):
        h.observe(v)
    reg.histogram("sim_round_duration_seconds").observe(0.75)
    return reg.snapshot(), reg.to_prometheus(), reg.names()


def test_metrics_registry_matches():
    assert _drive_metrics(tmetrics) == _drive_metrics(jmetrics)


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_groups_matches(seed):
    rng = np.random.default_rng(seed)
    items = [WorkItem("pair", node=f"n{rng.integers(0, 12)}", peer=f"n{rng.integers(0, 12)}",
                      steps=int(rng.integers(1, 3))) for _ in range(60)]
    sig = lambda it: None if it.steps == 2 and it.node < "n3" else ("pair", it.steps)  # noqa: E731
    want = jengine.plan_groups(items, sig)
    got = tengine.plan_groups(items, sig)
    assert [[tuple(it) for it in g] for g in got] == [[tuple(it) for it in g] for g in want]
    assert any(len(g) > 1 for g in got)


def test_embedding_provenance_matches_after_migrations():
    """``embed_src`` is kept at init, gather and migration as the
    reference keeps it, and rebuilding it from the topology gives the same
    arrays; the cohort-weighted bridge distribution follows."""
    from repro.configs.base import FLConfig as JConfig
    from repro.core.fedeec import FedEEC as JFedEEC
    from repro.models.autoencoder import init_autoencoder
    from repro_torch import convert
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.fedeec import FedEEC

    tiny = dict(num_clients=6, num_edges=3, samples_per_client=4, image_size=8,
                embed_dim=16, edge_model="cnn2", cloud_model="cnn2")
    rng = np.random.default_rng(1)
    data = {f"client{i}": (rng.random((3 + i, 8, 8, 3), dtype=np.float32),
                           rng.integers(0, 10, 3 + i)) for i in range(6)}
    auto = init_autoencoder(jax.random.PRNGKey(5), image=8, embed_dim=16)
    jt = JFedEEC(JConfig(**tiny), JTree.three_tier(3, 6), data, auto)
    tt = FedEEC(FLConfig(**tiny), Tree.three_tier(3, 6), data,
                convert.from_jax("autoencoder", jax.tree.map(np.asarray, auto)), device="cpu")
    for tr in (jt, tt):
        for node, target in (("client0", "edge1"), ("client3", "edge1"), ("edge2", "edge0")):
            assert tr.try_migrate(node, target)
        tr.set_cohort_sizes({v: 1 + i for i, v in enumerate(sorted(data))})
    assert tt.embed_src.keys() == jt.embed_src.keys()
    for v in jt.embed_src:
        assert np.array_equal(tt.embed_src[v], jt.embed_src[v]), v
        assert tt.embed_src[v].dtype == jt.embed_src[v].dtype
        if len(tt.embed_src[v]):
            assert np.array_equal(tt._bridge_p(v), jt._bridge_p(v)), v
    kept = {v: a.copy() for v, a in tt.embed_src.items()}
    tt._rebuild_embed_src()
    assert all(np.array_equal(tt.embed_src[v], kept[v]) for v in kept)
    assert tt.cohort_size("client5") == 6 and tt.cohort_size("edge0") == 1
