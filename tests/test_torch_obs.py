"""The port's telemetry plane (``repro_torch.obs``): the tracer, the Chrome
export, the metrics registry, critical-path attribution and the report CLI,
each as ``tests/test_obs.py`` holds the reference's, and then against the
reference itself on the CPU.

The simulator runs are the gate configuration of
``benchmarks/tables/scenarios.json`` (4 clients, 2 edges, cnn2 edge and
cloud, 2 rounds, no eval). Every comparison is exact: the simulated timeline
is a function of the schedule alone, which both packages compute bit for bit.
One difference is stated, not hidden: the port's FedEEC and baselines compute
their losses and SKR through the kernel ops, so a traced port run has the
reference's span categories plus ``kernel``; the reference's compute them in
jnp, outside its ops. Host-side args (``span`` / ``parent`` ids, which the
kernel spans shift, and ``host_dur_us``) are dropped before comparing.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.fedeec_paper import paper_setting
from repro_torch.fl.api import create_algorithm
from repro_torch.fl.engine import build_problem, run_experiment
from repro_torch.obs import critical_path as tcp
from repro_torch.obs.critical_path import _factor, rounds_from_eventlog, rounds_from_trace
from repro_torch.obs.metrics import MetricsRegistry, global_registry
from repro_torch.obs.report import main as report_main
from repro_torch.obs.trace import SIM_PID, Tracer, active_tracer, tracing
from repro_torch.sim.engine import SimEngine
from repro_torch.sim.events import EventLog
from repro_torch.sim.scenarios import get_scenario, list_scenarios

ROOT = Path(__file__).resolve().parent.parent
BENCH_OBS = json.loads((ROOT / "BENCH_obs.json").read_text())
GATE = dict(samples_per_client=16, test_samples=64, image_size=8, embed_dim=16,
            edge_model="cnn2", cloud_model="cnn2")
# the runs whose traces are held to the reference's
CROSS_RUNS = [("fedeec", "straggler_heavy"), ("fedeec", "mobile_clients"),
              ("fedeec", "lossy_links"), ("hierfavg", "regional_outage")]
HOST_ARGS = ("span", "parent", "host_dur_us")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a worker: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def port_engine(name, algorithm="fedeec", rounds=2, tracer=None):
    """``rounds`` rounds of ``algorithm`` through scenario ``name`` at the
    gate configuration on the CPU, traced when ``tracer`` is given."""
    cfg = paper_setting("synth_cifar10", 4, 2, **GATE)
    _, tree, client_data, auto = build_problem(cfg, device="cpu")
    trainer = create_algorithm(algorithm, cfg, tree, client_data, auto, device="cpu")
    engine = SimEngine(trainer, get_scenario(name), seed=cfg.seed, tracer=tracer)
    with tracing(tracer):
        engine.run(rounds)
    return engine


def sim_events(doc: dict) -> list:
    """The simulated-time process's events of a Chrome trace, host-side
    args dropped."""
    out = []
    for e in doc["traceEvents"]:
        if e["pid"] != SIM_PID:
            continue
        e = dict(e)
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items() if k not in HOST_ARGS}
        out.append(e)
    return out


_CROSS: dict = {}


def cross_run(algorithm, name) -> dict:
    """The reference's and the port's traced run of ``algorithm`` through
    ``name``, each trace through JSON as a file holds it, and their event
    logs; computed once per run. The schedule does not depend on the
    autoencoder's values, so the reference's run skips its pretrain."""
    key = (algorithm, name)
    if key in _CROSS:
        return _CROSS[key]
    import jax

    import repro.fl.engine as jengine
    from repro.configs.fedeec_paper import paper_setting as j_paper_setting
    from repro.models.autoencoder import init_autoencoder
    from repro.obs.trace import Tracer as JTracer
    from repro.obs.trace import tracing as j_tracing
    from repro.sim.engine import SimEngine as JSimEngine
    from repro.sim.scenarios import get_scenario as j_get_scenario

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "_pretrained_auto", lambda cfg, x: init_autoencoder(
            jax.random.PRNGKey(0), image=cfg.image_size, embed_dim=cfg.embed_dim))
        cfg = j_paper_setting("synth_cifar10", 4, 2, **GATE)
        _, tree, client_data, auto = jengine.build_problem(cfg)
        trainer = jengine.create_algorithm(algorithm, cfg, tree, client_data, auto)
        jtr = JTracer()
        jeng = JSimEngine(trainer, j_get_scenario(name), seed=cfg.seed, tracer=jtr)
        with j_tracing(jtr):
            jeng.run(2)
    ttr = Tracer()
    teng = port_engine(name, algorithm, tracer=ttr)
    _CROSS[key] = out = {
        "ref_trace": json.loads(json.dumps(jtr.to_chrome())),
        "port_trace": json.loads(json.dumps(ttr.to_chrome())),
        "ref_log": jeng.log.entries, "port_log": teng.log.entries,
        "ref_cats": {sp.cat for sp in jtr.spans}, "port_cats": {sp.cat for sp in ttr.spans},
    }
    return out


# ---------------------------------------------------------------------------
# Tracer (tests/test_obs.py's, on the port's modules)
# ---------------------------------------------------------------------------


def test_span_nesting_and_ordering():
    tr = Tracer()
    with tr.span("outer", cat="round") as outer:
        with tr.span("mid", cat="dispatch") as mid:
            with tr.span("inner", cat="kernel") as inner:
                pass
        with tr.span("sibling", cat="dispatch") as sib:
            pass
    assert [sp.sid for sp in tr.spans] == [0, 1, 2, 3]
    assert outer.parent == -1
    assert mid.parent == outer.sid
    assert inner.parent == mid.sid
    assert sib.parent == outer.sid  # reopened at the right depth
    for sp in tr.spans:
        assert sp.t1_host >= sp.t0_host >= 0.0


def test_add_span_parents_under_open_span():
    tr = Tracer()
    with tr.span("round 0", cat="round") as rsp:
        it = tr.add_span("pair a->b", cat="item", node="a",
                         sim_t0=1.0, sim_t1=2.5, peer="b")
    orphan = tr.add_span("late", cat="item", node="c", sim_t0=0.0, sim_t1=1.0)
    assert it.parent == rsp.sid
    assert orphan.parent == -1
    assert it.sim_t1 - it.sim_t0 == pytest.approx(1.5)


def test_active_tracer_plumbing():
    assert active_tracer() is None
    tr = Tracer()
    with tracing(tr):
        assert active_tracer() is tr
        with tracing(None):
            assert active_tracer() is None
        assert active_tracer() is tr
    assert active_tracer() is None


def test_chrome_trace_schema():
    tr = Tracer()
    with tr.span("round 0", cat="round", sim_t0=0.0, round=0) as rsp:
        tr.add_span("pair a->b", cat="item", node="a",
                    sim_t0=0.0, sim_t1=1.0, peer="b", round=0)
        tr.instant("rejoin", sim_t=0.5, node="b")
        rsp.sim_t1 = 1.0
    with tr.span("host only", cat="eval"):
        pass
    doc = tr.to_chrome()
    json.loads(json.dumps(doc))  # serializable round trip
    evs = doc["traceEvents"]
    assert all("ph" in e and "pid" in e for e in evs)
    meta = [e for e in evs if e["ph"] == "M"]
    assert {e["args"]["name"] for e in meta if e["name"] == "process_name"} \
        == {"sim (simulated time)", "host (wall clock)"}
    rows = {e["args"]["name"] for e in meta if e["name"] == "thread_name"}
    assert {"scheduler", "a", "b"} <= rows
    xs = [e for e in evs if e["ph"] == "X"]
    assert all(isinstance(e["ts"], float) and e["dur"] >= 0 for e in xs)
    item = next(e for e in xs if e["cat"] == "item")
    # node rides in args so rounds_from_trace can rebuild attribution
    assert item["args"]["node"] == "a"
    assert item["ts"] == 0.0 and item["dur"] == pytest.approx(1e6)
    host = next(e for e in xs if e["cat"] == "eval")
    assert host["pid"] != item["pid"]
    assert any(e["ph"] == "i" for e in evs)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def test_metrics_snapshot_roundtrip():
    reg = MetricsRegistry()
    reg.counter("sim_dispatches_total").inc()
    reg.counter("sim_link_bytes_total", link="end-edge").inc(1024)
    reg.counter("sim_link_bytes_total", link="edge-cloud").inc(2048)
    reg.gauge("sim_straggler_compute_factor", node="client1").set(8.0)
    h = reg.histogram("sim_round_duration_seconds")
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap == json.loads(json.dumps(snap))
    assert snap['sim_link_bytes_total{link="end-edge"}']["value"] == 1024
    hd = snap["sim_round_duration_seconds"]
    assert hd["count"] == 3 and hd["sum"] == pytest.approx(5.55)
    assert hd["min"] == 0.05 and hd["max"] == 5.0
    assert sum(hd["buckets"].values()) == hd["count"]
    assert reg.names() == sorted(reg.names())


def test_metrics_type_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("sim_dispatches_total")
    with pytest.raises(TypeError):
        reg.gauge("sim_dispatches_total")


def test_prometheus_exposition():
    reg = MetricsRegistry()
    reg.counter("sim_dispatches_total").inc(3)
    reg.histogram("kernel_dispatch_seconds", kernel="skr").observe(0.002)
    text = reg.to_prometheus()
    assert "# TYPE sim_dispatches_total counter" in text
    assert "sim_dispatches_total 3" in text
    assert "# TYPE kernel_dispatch_seconds histogram" in text
    assert 'kernel_dispatch_seconds_bucket{kernel="skr",le="+Inf"} 1' in text
    assert 'kernel_dispatch_seconds_count{kernel="skr"} 1' in text


# ---------------------------------------------------------------------------
# Critical path
# ---------------------------------------------------------------------------


def _entry(t, kind, seq=0, **kw):
    return {"t": t, "seq": seq, "kind": kind, **kw}


def test_critical_path_two_edge_eventlog():
    # two edges; client1 is an 8x straggler whose chain gates the round:
    #   client1->edge1 [0, 0.8] --> edge1->cloud [0.8, 1.0]
    # while the edge0 subtree finishes early with slack.
    log = [
        _entry(0.0, "straggle", seq=-1, node="client1", slowdown=8.0),
        _entry(0.0, "round_start", seq=-1, round=0),
        _entry(0.0, "pair_start", node="client0", target="edge0"),
        _entry(0.0, "pair_start", node="client1", target="edge1"),
        _entry(0.1, "pair_done", node="client0", target="edge0", bytes=64),
        _entry(0.1, "pair_start", node="edge0", target="cloud"),
        _entry(0.3, "pair_done", node="edge0", target="cloud", bytes=256),
        _entry(0.8, "pair_done", node="client1", target="edge1", bytes=64),
        _entry(0.8, "pair_start", node="edge1", target="cloud"),
        _entry(1.0, "pair_done", node="edge1", target="cloud", bytes=256),
        _entry(1.0, "round_end", seq=-1, round=0),
    ]
    reports = rounds_from_eventlog(log)
    assert len(reports) == 1
    rep = reports[0]
    assert rep.makespan == pytest.approx(1.0)
    assert [(it.node, it.peer) for it in rep.path] == [
        ("client1", "edge1"), ("edge1", "cloud")]
    assert rep.gate_node == "client1"
    assert rep.gate_factor == "straggle"
    assert rep.gate.straggle == 8.0
    assert rep.slack == [pytest.approx(0.7), pytest.approx(0.9)]


def test_critical_path_from_trace_matches_and_splits_factor():
    tr = Tracer()
    with tr.span("round 0", cat="round", sim_t0=0.0, round=0) as rsp:
        tr.add_span("pair client1->edge1", cat="item", node="client1",
                    sim_t0=0.0, sim_t1=0.8, peer="edge1", round=0,
                    compute_s=0.78, transfer_s=0.02,
                    straggle=8.0, straggle_node="client1")
        tr.add_span("pair client0->edge0", cat="item", node="client0",
                    sim_t0=0.0, sim_t1=0.1, peer="edge0", round=0,
                    compute_s=0.08, transfer_s=0.02, straggle=1.0)
        tr.add_span("pair edge1->cloud", cat="item", node="edge1",
                    sim_t0=0.8, sim_t1=1.0, peer="cloud", round=0,
                    compute_s=0.05, transfer_s=0.15, straggle=1.0)
        rsp.sim_t1 = 1.0
    reports = rounds_from_trace(tr.to_chrome())
    assert len(reports) == 1
    rep = reports[0]
    assert [(it.node, it.peer) for it in rep.path] == [
        ("client1", "edge1"), ("edge1", "cloud")]
    assert rep.gate_node == "client1" and rep.gate_factor == "straggle"
    # a transfer-bound, non-straggling item reports the exact factor
    tail = rep.path[-1]
    assert tail.transfer_s > tail.compute_s
    assert _factor(tail) == "transfer"


# ---------------------------------------------------------------------------
# Event-log ordinals + no-perturbation guarantee
# ---------------------------------------------------------------------------


def test_eventlog_ord_monotonic_and_excluded_from_signature():
    log = EventLog()
    log.note(0.0, "round_start", round=0)
    log.note(1.0, "round_end", round=0)
    log.note(2.0, "round_start", round=1)
    assert [e["ord"] for e in log.entries] == [0, 1, 2]
    sig = log.signature()
    for e in log.entries:
        e["ord"] += 100  # ord must never reach the content hash
    assert log.signature() == sig


def test_tracing_does_not_perturb_event_log():
    """``run_experiment(tracer=)`` with an eval: the same log, ``ord``s
    included, and the eval and kernel spans nest under the installed
    tracer."""
    cfg = paper_setting("synth_cifar10", 4, 2, scenario="straggler_heavy", **GATE)
    plain = run_experiment("fedeec", cfg, rounds=1, eval_every=1, device="cpu")
    tr = Tracer()
    traced = run_experiment("fedeec", cfg, rounds=1, eval_every=1, tracer=tr, device="cpu")
    assert traced.event_signature == plain.event_signature
    assert traced.event_log == plain.event_log  # ords included
    assert {sp.cat for sp in tr.spans} == set(BENCH_OBS["span_categories"]) | {"eval", "kernel"}
    assert active_tracer() is None


# ---------------------------------------------------------------------------
# Eval metrics satellite
# ---------------------------------------------------------------------------


def test_accuracy_observes_fl_eval_wall_seconds_once_per_call():
    from repro_torch.fl.metrics import accuracy

    def apply(p, xb):
        return xb.reshape(len(xb), -1) @ p

    hist = global_registry().histogram("fl_eval_wall_seconds")
    x = np.eye(3, dtype=np.float32).reshape(3, 3, 1, 1)
    for calls in (1, 2):
        before = hist.count
        accs = [accuracy(apply, torch.eye(3), x, np.arange(3), batch=2) for _ in range(calls)]
        assert accs == [1.0] * calls
        assert hist.count == before + calls


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm,name", CROSS_RUNS)
def test_sim_trace_events_equal_the_references(algorithm, name):
    """The simulated-time process of the port's Chrome trace equals the
    reference's event for event, in order (exact); the span categories
    differ by ``kernel`` alone."""
    run = cross_run(algorithm, name)
    assert run["port_log"] == run["ref_log"]
    ref, port = sim_events(run["ref_trace"]), sim_events(run["port_trace"])
    assert len(port) > 0 and port == ref
    assert any(e.get("cat") == "item" for e in port)
    assert run["port_cats"] - run["ref_cats"] == {"kernel"}
    assert run["ref_cats"] <= run["port_cats"]


@pytest.mark.parametrize("algorithm,name", CROSS_RUNS)
def test_explain_equals_the_references(algorithm, name):
    """``explain`` of the port's reports, from its trace and from its event
    log, equals the reference's as strings (exact)."""
    from repro.obs import critical_path as jcp

    run = cross_run(algorithm, name)
    assert tcp.explain(tcp.rounds_from_trace(run["port_trace"])) \
        == jcp.explain(jcp.rounds_from_trace(run["ref_trace"]))
    assert tcp.explain(tcp.rounds_from_eventlog(run["port_log"])) \
        == jcp.explain(jcp.rounds_from_eventlog(run["ref_log"]))


@pytest.mark.parametrize("algorithm,name", CROSS_RUNS)
def test_each_package_reads_the_others_trace(algorithm, name):
    """The port's ``rounds_from_trace`` of the reference's trace gives the
    reference's reports, field for field, and the reverse (exact)."""
    from repro.obs import critical_path as jcp

    run = cross_run(algorithm, name)
    for doc in (run["ref_trace"], run["port_trace"]):
        ours = [dataclasses.asdict(r) for r in tcp.rounds_from_trace(doc)]
        theirs = [dataclasses.asdict(r) for r in jcp.rounds_from_trace(doc)]
        assert len(ours) == 2 and ours == theirs


@pytest.mark.parametrize("algorithm", ["fedeec", "hierfavg"])
@pytest.mark.parametrize("name", list_scenarios())
def test_traced_and_untraced_logs_are_identical(name, algorithm):
    """A traced run prices every item through the general loop, which must
    price a fault-free item exactly as the fast path does: the log,
    ``ord``s included, and the signature are the untraced run's, and there
    is an item span for every priced item."""
    plain = port_engine(name, algorithm)
    tr = Tracer()
    traced = port_engine(name, algorithm, tracer=tr)
    assert traced.log.entries == plain.log.entries
    assert traced.log.signature() == plain.log.signature()
    items = [sp for sp in tr.spans if sp.cat == "item"]
    assert len(items) == plain.log.count("pair_start") > 0
    assert [sp.name for sp in tr.spans if sp.cat == "round"] == ["round 0", "round 1"]


def test_bench_obs_contract():
    """``BENCH_obs.json``'s contract at ``benchmarks/obs_bench.py``'s
    configuration (straggler_heavy, 4 clients, 2 edges, cnn2, 1 round):
    the simulator's metric names, the span categories plus ``kernel`` (the
    port's one extra category), round 0's gate, and both global metric
    names after one eval."""
    from repro_torch.fl.metrics import accuracy

    tr = Tracer()
    engine = port_engine("straggler_heavy", rounds=1, tracer=tr)
    assert engine.metrics.names() == BENCH_OBS["sim_metric_names"]
    assert sorted({sp.cat for sp in tr.spans if sp.cat}) \
        == sorted(BENCH_OBS["span_categories"] + ["kernel"])
    gate = rounds_from_eventlog(engine.log.entries)[0]
    assert {"node": gate.gate_node, "factor": gate.gate_factor} == BENCH_OBS["round0_gate"]
    accuracy(engine.trainer.cloud_apply(), engine.trainer.cloud_params(),
             np.zeros((2, 8, 8, 3), np.float32), np.zeros(2, np.int64))
    assert set(BENCH_OBS["global_metric_names"]) <= set(global_registry().names())


def test_report_cli_reads_a_trace_and_an_event_log(tmp_path, capsys):
    """``python -m repro_torch.obs.report`` on the port's trace and event
    log, and on a file that is neither (exit 2)."""
    run = cross_run("fedeec", "straggler_heavy")
    trace, log, bad = tmp_path / "t.json", tmp_path / "log.json", tmp_path / "bad.json"
    trace.write_text(json.dumps(run["port_trace"]))
    log.write_text(json.dumps(run["port_log"]))
    bad.write_text(json.dumps({"not": "a trace"}))
    assert report_main([str(trace)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("source: trace") and "gated by: node client1" in out
    assert report_main([str(log), "--json"]) == 0
    rounds = json.loads(capsys.readouterr().out)
    assert [r["round"] for r in rounds] == [0, 1]
    assert rounds[0]["gate_node"] == "client1" and rounds[0]["gate_factor"] == "straggle"
    assert report_main([str(trace), "--round", "1", "--json"]) == 0
    assert [r["round"] for r in json.loads(capsys.readouterr().out)] == [1]
    assert report_main([str(trace), "--round", "7"]) == 2
    assert report_main([str(bad)]) == 2
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", str(bad)],
                          capture_output=True, text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert proc.returncode == 2 and "neither a Chrome trace" in proc.stderr
