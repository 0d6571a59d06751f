"""The scenario path end to end: ``run_experiment(..., scenario=...)`` of the
port against the JAX package's, both on the CPU, from the same parameters.

Tiny config: 4 clients, 2 edges, 16 samples each, 8x8 images, embed 16,
cnn1 / cnn2 / cnn2, 2 rounds. Both runs take their autoencoder and every
node's initial parameters from the JAX run (converted): the JAX side's
``create_algorithm`` is wrapped to keep them, the port's to use them. The
runs here hold both trainers to serial dispatch (``batch_signature`` ->
``None``, as the reference's tests force it), so that the serial pair path
stays compared end to end on the scenario path; ``tests/test_torch_batching.py``
compares the two packages' batched dispatch with ``run_both(serial=False)``.
"""
import jax
import numpy as np
import pytest
import torch

import repro.fl.engine as jengine
import repro_torch.fl.engine as tengine
import repro_torch.sim.faults as tfaults
from repro.configs.base import FLConfig as JConfig
from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core.fedeec import FedEEC

TINY = dict(num_clients=4, num_edges=2, samples_per_client=16, test_samples=64,
            image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2")
# the plain path's bound (tests/test_torch_fedeec.py): fp32 convolutions in
# another order, through a few AdamW steps
PARAM_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The suite's workers share the machine's cores, and torch's default
    of one intra-op thread per core then oversubscribes them many times
    over (a CPU FedEEC run here slowed thirtyfold): two threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


kept: dict = {}


def run_both(monkeypatch, serial=True, **kw):
    """(JAX result, JAX trainer, port result, port trainer) of one run,
    both trainers forced to serial dispatch unless ``serial`` is false;
    ``kept`` holds what the wrappers saw."""
    kept.clear()
    j_create = jengine.create_algorithm

    def j_wrap(name, cfg, tree, client_data, auto):
        tr = j_create(name, cfg, tree, client_data, auto)
        if serial:
            tr.batch_signature = lambda item: None
        kept.update(trainer=tr, auto=auto, params=dict(tr.params),
                    labels={v: y.copy() for v, (_, y) in client_data.items()})
        return tr

    def t_wrap(name, cfg, tree, client_data, auto, *, device):
        jt = kept["trainer"]
        params = {v: convert.from_jax(jt.model_of[v], _np(p))
                  for v, p in kept["params"].items()}
        tr = FedEEC(cfg, tree, client_data, auto, use_skr=True, seed=cfg.seed,
                    device=device, params=params)
        if serial:
            tr.batch_signature = lambda item: None
        kept["port"] = tr
        return tr

    t_noise = tfaults.apply_label_noise

    def noise_spy(*args):
        out = t_noise(*args)
        kept["byzantine"] = out[1]
        return out

    monkeypatch.setattr(tfaults, "apply_label_noise", noise_spy)
    monkeypatch.setattr(jengine, "create_algorithm", j_wrap)
    monkeypatch.setattr(tengine, "create_algorithm", t_wrap)
    monkeypatch.setattr(tengine, "_pretrained_auto", lambda cfg, x_open, dev:
                        convert.from_jax("autoencoder", _np(kept["auto"]), dev))
    jres = jengine.run_experiment("fedeec", JConfig(**TINY), rounds=2, **kw)
    tres = tengine.run_experiment("fedeec", FLConfig(**TINY), rounds=2, device="cpu", **kw)
    # the trainer saw the same (possibly noisy) labels on both sides
    for v, y in kept["labels"].items():
        assert np.array_equal(kept["port"].client_data[v][1], y), v
    return jres, kept["trainer"], tres, kept["port"]


def check_parity(jres, jt, tres, tt):
    assert tres.event_signature == jres.event_signature
    assert tres.event_log == jres.event_log
    assert tres.event_counts == jres.event_counts
    assert tres.comm_bytes == jres.comm_bytes
    assert tres.sim_times == jres.sim_times and tres.sim_wall_s == jres.sim_wall_s
    assert tt.rng.bit_generator.state == jt.rng.bit_generator.state
    assert tt.failed_pairs == jt.failed_pairs
    assert tres.metrics == jres.metrics
    want = jax.tree.leaves(_np(jt.cloud_params()))
    got = jax.tree.leaves(convert.to_jax(tt.model_of[tt.tree.root], tt.cloud_params()))
    worst = max(float(np.abs(a - b).max()) for a, b in zip(want, got))
    assert worst < PARAM_TOL, worst
    np.testing.assert_allclose(tres.acc_curve, jres.acc_curve, rtol=0, atol=PARAM_TOL)
    return worst


@pytest.mark.parametrize("scenario", ["mobile_clients", "megacity", "byzantine_noise"])
def test_scenario_run_matches_jax(monkeypatch, scenario):
    jres, jt, tres, tt = run_both(monkeypatch, scenario=scenario)
    worst = check_parity(jres, jt, tres, tt)
    print(f"{scenario}: cloud params max|diff| {worst:.3e}")
    assert tres.scenario == scenario and len(tres.round_s) == 2
    # forced serial on both sides: no group ran as one dispatch
    assert tres.dispatch_stats["batched_dispatches"] == 0
    counts = tres.event_counts
    # each scenario exercised what it is chosen for
    if scenario == "mobile_clients":
        assert counts.get("migrate", 0) > 0
    elif scenario == "megacity":
        assert tt._cohort_sizes and tt._bridge_p_cache
    else:
        assert kept["byzantine"], "no client's labels were flipped"


def test_chaos_faults_match_jax(monkeypatch):
    jres, jt, tres, tt = run_both(monkeypatch, scenario="stable", faults="chaos")
    check_parity(jres, jt, tres, tt)
    assert tt.failed_pairs, "chaos lost no pair: the comparison covered nothing"


def test_stop_after_ends_after_one_round(monkeypatch):
    jres, jt, tres, tt = run_both(monkeypatch, scenario="mobile_clients", stop_after=1)
    check_parity(jres, jt, tres, tt)
    # the round's eval runs, then the run ends
    assert tres.event_counts["round_end"] == 1 == jres.event_counts["round_end"]
    assert len(tres.acc_curve) == 1 and len(tres.round_s) == 1
