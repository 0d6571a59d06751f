"""The port's batched pair path (coalesced BSBODP groups), counterpart of
``tests/test_batching.py``: the stacked trees, optimizer, SKR and losses
against their per-pair forms, FedEEC's ``batch_signature`` against the JAX
package's, ``execute_batch`` against serial execution, the simulator's
coalescing counts against ``BENCH_kernels.json``, and batched scenario runs
against the JAX package's batched runs, all on the CPU.

Tiny configuration: 4 clients, 2 edges, 16 samples each, 8x8 images,
embed 16, cnn1 / cnn2 / cnn2.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs.fedeec_paper import paper_setting
from repro_torch.core import bsbodp
from repro_torch.core.skr import skr_init, skr_process_batch
from repro_torch.fl.api import create_algorithm
from repro_torch.fl.engine import build_problem
from repro_torch.optim import adamw_init, adamw_update_, adamw_update_stacked_
from repro_torch.sim.engine import SimEngine, plan_groups
from repro_torch.sim.scenarios import get_scenario
from repro_torch.tree import tree_leaves, tree_map, tree_stack, tree_unstack, value_and_grad
from test_torch_sim_numerics import check_parity, run_both

ROOT = Path(__file__).resolve().parent.parent
BENCH_KERNELS = json.loads((ROOT / "BENCH_kernels.json").read_text())
SMALL = dict(samples_per_client=16, test_samples=64, image_size=8, embed_dim=16,
             edge_model="cnn2", cloud_model="cnn2")
# execute_batch against serial execute: the same bound as the reference's
# tests/test_batching.py (vmapped convolutions sum in another order)
BATCH_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a worker: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _fedeec(clients=4, edges=2):
    cfg = paper_setting("synth_cifar10", clients, edges, **SMALL)
    _, tree, client_data, auto = build_problem(cfg, device="cpu")
    return create_algorithm("fedeec", cfg, tree, client_data, auto, device="cpu")


def _max_diff(x, y):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(tree_leaves(x), tree_leaves(y)))


# --- the stacked pieces ---------------------------------------------------------


def test_tree_unstack_gives_each_tree_its_own_tensors():
    trees = [{"w": torch.full((2, 3), float(b)), "b": [torch.full((3,), -float(b))]}
             for b in range(3)]
    stacked = tree_stack(trees)
    assert stacked["w"].shape == (3, 2, 3) and stacked["b"][0].shape == (3, 3)
    out = tree_unstack(stacked, 3)
    for b, tree in enumerate(out):
        assert _max_diff(tree, trees[b]) == 0.0
    out[0]["w"].add_(10.0)  # an in-place update of one tree writes nothing else
    assert float(stacked["w"][0].max()) == 0.0 and float(out[1]["w"].max()) == 1.0
    assert out[0]["w"].is_contiguous() and out[0]["w"].untyped_storage().data_ptr() \
        != stacked["w"].untyped_storage().data_ptr()


def _opt_tree(rng, B_last):
    """Leaves of rank 1, 2 and 4, and a bias whose last dim is ``B_last``."""
    return {
        "conv": rng.standard_normal((4, 3, 3, 3)).astype(np.float32),
        "fc": {"w": rng.standard_normal((6, B_last)).astype(np.float32),
               "b": rng.standard_normal((B_last,)).astype(np.float32)},
        "gn_s": rng.standard_normal((4,)).astype(np.float32),
    }


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_stacked_adamw_matches_per_tree_updates(weight_decay):
    """B = 10 trees at unequal step counts (0 to 9 earlier steps), with a
    (10,) bias: a bias correction broadcast against the last axis instead
    of the leading one would go unnoticed in shape there."""
    B = 10
    rng = np.random.default_rng(0)
    params = [tree_map(torch.from_numpy, _opt_tree(rng, B)) for _ in range(B)]
    opts = [adamw_init(p) for p in params]
    for b in range(B):
        for _ in range(b):
            g = tree_map(torch.from_numpy, _opt_tree(rng, B))
            adamw_update_(g, opts[b], params[b], lr=1e-2, weight_decay=weight_decay)
    P, O = tree_stack(params), tree_stack(opts)
    assert O["step"].tolist() == list(range(B))
    for _ in range(2):
        grads = [tree_map(torch.from_numpy, _opt_tree(rng, B)) for _ in range(B)]
        for b in range(B):
            adamw_update_(grads[b], opts[b], params[b], lr=1e-2,
                          weight_decay=weight_decay)
        adamw_update_stacked_(tree_stack(grads), O, P, lr=1e-2,
                              weight_decay=weight_decay)
    for b, (p, o) in enumerate(zip(tree_unstack(P, B), tree_unstack(O, B))):
        assert _max_diff(p, params[b]) <= 1e-7, b
        assert _max_diff(o, opts[b]) <= 1e-7, b
        assert int(o["step"]) == b + 2 and o["step"].dtype == torch.int32


def test_stacked_adamw_decays_by_the_unstacked_rank():
    P = {"w": torch.ones(3, 2, 2), "b": torch.ones(3, 2)}
    G = tree_map(torch.zeros_like, P)
    adamw_update_stacked_(G, tree_stack([adamw_init(tree_map(lambda x: x[0], P))] * 3), P,
                          lr=0.5, weight_decay=0.1)
    assert torch.all(P["w"] < 1.0)
    assert torch.equal(P["b"], torch.ones(3, 2))  # a (B, 2) bias is a rank-1 leaf


def test_skr_process_batch_of_stacked_pairs_matches_per_pair():
    B, N, C, Bq = 3, 24, 10, 5
    rng = np.random.default_rng(2)
    probs = torch.from_numpy(rng.dirichlet(np.ones(C) * 0.3, (B, N)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, C, (B, N)))
    states = [skr_init(C, Bq) for _ in range(B)]
    for b, st in enumerate(states):  # unequal queue fills
        st["count"][: b + 2] = torch.arange(b + 2, dtype=torch.int32) % (Bq + 1)
        st["head"][: b + 2] = torch.arange(b + 2, dtype=torch.int32) % Bq
        st["q"][:] = torch.from_numpy(rng.random((C, Bq)).astype(np.float32))
    new, Q = skr_process_batch(tree_stack(states), probs, labels)
    for b, st in enumerate(states):
        want_state, want_Q = skr_process_batch(st, probs[b], labels[b])
        assert torch.equal(Q[b], want_Q)
        for k in ("q", "count", "head"):
            assert torch.equal(new[k][b], want_state[k]), k


def _loss_inputs(B=3, N=8, C=10, seed=0):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy((rng.standard_normal((B, N, C)) * 2).astype(np.float32))
    zl = torch.from_numpy((rng.standard_normal((B, N, C)) * 2).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, (B, N)))
    yl = torch.from_numpy(rng.integers(0, C, (B, N)))
    q = rng.random((B, N, C)) ** 3
    q = torch.from_numpy((q / q.sum(-1, keepdims=True)).astype(np.float32))
    z[1, 0, :] = 0.0  # one row past the CE cap: pair 1's row 0 gold prob < 1e-12
    z[1, 0, y[1, 0]] = -40.0
    return z, zl, y, yl, q


@pytest.mark.parametrize("leaf", [False, True])
def test_batched_losses_match_per_pair(leaf):
    """Per-pair (B,) losses and the gradient of their sum against each
    pair's serial loss and gradient."""
    z, zl, y, yl, q = _loss_inputs()
    beta, gamma = 1.5, 0.7
    if leaf:
        fn = lambda p: bsbodp.leaf_loss_batched(p[1], yl, p[0], y, q, beta, gamma)
        one = lambda b, p: bsbodp.leaf_loss(p[1], yl[b], p[0], y[b], q[b], beta, gamma)
        inputs = [z, zl]
    else:
        fn = lambda p: bsbodp.non_leaf_loss_batched(p[0], y, q, beta)
        one = lambda b, p: bsbodp.non_leaf_loss(p[0], y[b], q[b], beta)
        inputs = [z]
    losses = fn(inputs)
    assert losses.shape == (3,)
    _, grads = value_and_grad(lambda p: fn(p).sum(), inputs)
    for b in range(3):
        lb, gb = value_and_grad(lambda p, b=b: one(b, p), [x[b] for x in inputs])
        torch.testing.assert_close(losses[b], lb, rtol=0, atol=1e-6)
        for g, g1 in zip(grads, gb):
            torch.testing.assert_close(g[b], g1, rtol=0, atol=1e-7)


# --- FedEEC ------------------------------------------------------------------


def test_batch_signature_groups_same_shape_leaf_pairs():
    trainer = _fedeec()
    items = [it for it in trainer.work_items(0, lambda v: True)
             if it.node in trainer.client_data]
    sigs = [trainer.batch_signature(it) for it in items]
    assert all(s is not None for s in sigs)
    assert any(sigs[i] == sigs[j] and items[i].peer != items[j].peer
               for i in range(len(items)) for j in range(i + 1, len(items)))
    edge_items = [it for it in trainer.work_items(0, lambda v: True)
                  if it.node not in trainer.client_data]
    assert edge_items and all(trainer.batch_signature(it) not in sigs for it in edge_items)
    # edge pairs all share the cloud: they never land in one group
    assert all(len(g) == 1 for g in plan_groups(edge_items, trainer.batch_signature))


def test_batch_signature_equals_the_references(monkeypatch):
    """The JAX package's FedEEC over the same problem gives each work item
    the same signature (the schedule does not depend on the autoencoder's
    values, so the JAX problem skips its pretrain)."""
    import repro.fl.engine as jengine
    from repro.configs.fedeec_paper import paper_setting as j_paper_setting
    from repro.models.autoencoder import init_autoencoder

    monkeypatch.setattr(jengine, "_pretrained_auto", lambda cfg, x: init_autoencoder(
        jax.random.PRNGKey(0), image=cfg.image_size, embed_dim=cfg.embed_dim))
    cfg = j_paper_setting("synth_cifar10", 4, 2, **SMALL)
    _, tree, client_data, auto = jengine.build_problem(cfg)
    jt = jengine.create_algorithm("fedeec", cfg, tree, client_data, auto)
    tt = _fedeec()
    jitems = jt.work_items(0, lambda v: True)
    assert jitems == tt.work_items(0, lambda v: True)
    assert [tt.batch_signature(it) for it in jitems] == \
        [jt.batch_signature(it) for it in jitems]


class _ConstRng:
    """rng stub whose draws depend only on (n, size): serial and batched
    execution then draw identical per-pair indices whatever the order of
    the draws (the reference test's stub)."""

    def choice(self, n, size, replace):
        return np.random.default_rng(n * 131 + size).choice(n, size=size, replace=replace)


def test_execute_batch_matches_serial():
    a, b = _fedeec(), _fedeec()
    a.rng, b.rng = _ConstRng(), _ConstRng()
    items = [it for it in a.work_items(0, lambda v: True) if it.node in a.client_data]
    group = max(plan_groups(items, a.batch_signature), key=len)
    assert len(group) >= 2
    for _ in range(3):  # SKR's queues fill from the third call on
        for it in group:
            a.execute(it)
        b.execute_batch(group)
    nodes = {it.node for it in group} | {it.peer for it in group}
    for v in sorted(nodes):
        assert _max_diff(a.params[v], b.params[v]) < BATCH_TOL, v
        assert _max_diff(a.opt[v], b.opt[v]) < BATCH_TOL, v
        assert torch.equal(a.opt[v]["step"], b.opt[v]["step"]) and b.opt[v]["step"].dim() == 0
        assert _max_diff(a.skr[v], b.skr[v]) < BATCH_TOL, v
    assert a.comm.summary() == b.comm.summary()
    assert sum(int(b.skr[v]["count"].sum()) for v in nodes) > 0  # the queues saw pushes


def test_execute_batch_of_one_item_is_execute():
    a, b = _fedeec(), _fedeec()
    item = a.work_items(0, lambda v: True)[0]
    a.execute(item)
    b.execute_batch([item])
    for v in (item.node, item.peer):
        assert _max_diff(a.params[v], b.params[v]) == 0.0
    assert a.rng.bit_generator.state == b.rng.bit_generator.state


# --- the simulator -----------------------------------------------------------


def test_flash_crowd_counts_match_bench_kernels():
    want = BENCH_KERNELS["flash_crowd"]
    trainer = _fedeec(want["clients"], want["edges"])
    engine = SimEngine(trainer, get_scenario("flash_crowd"), seed=trainer.cfg.seed)
    engine.run(want["rounds"])
    stats = engine.dispatch_stats
    assert {"serial_pair_items": stats["items"], "dispatches": stats["dispatches"],
            "batched_dispatches": stats["batched_dispatches"],
            "batched_items": stats["batched_items"]} == \
        {k: want[k] for k in ("serial_pair_items", "dispatches", "batched_dispatches",
                              "batched_items")}


@pytest.mark.parametrize("scenario", ["stable", "flash_crowd"])
def test_sim_signature_identical_batched_vs_serial(scenario):
    def run(force_serial):
        trainer = _fedeec()
        if force_serial:
            trainer.batch_signature = lambda item: None
        engine = SimEngine(trainer, get_scenario(scenario), seed=trainer.cfg.seed)
        return engine.run(2).signature(), dict(engine.dispatch_stats)

    sig_batched, stats_batched = run(force_serial=False)
    sig_serial, stats_serial = run(force_serial=True)
    assert sig_batched == sig_serial
    assert stats_serial["batched_dispatches"] == 0
    assert stats_batched["batched_items"] > 0
    assert stats_batched["dispatches"] < stats_batched["items"] == stats_serial["items"]


@pytest.mark.parametrize("scenario, faults", [("mobile_clients", None), ("stable", "chaos")])
def test_batched_scenario_run_matches_jax(monkeypatch, scenario, faults):
    """Both packages with their coalesced dispatch: event log, signature,
    dispatch stats, comm bytes and rng state equal, cloud params and
    accuracy within ``check_parity``'s bound."""
    kw = {"faults": faults} if faults else {}
    jres, jt, tres, tt = run_both(monkeypatch, serial=False, scenario=scenario, **kw)
    worst = check_parity(jres, jt, tres, tt)
    stats = tres.dispatch_stats
    print(f"{scenario} batched: cloud params max|diff| {worst:.3e}  {stats}")
    assert stats == jres.dispatch_stats
    assert stats["dispatches"] < stats["items"]  # groups were planned
    # at this size chaos takes a member of every planned group, so each
    # group runs as its one live item (the engine's shrunk-group path)
    if faults:
        assert tt.failed_pairs, "chaos lost no pair: the comparison covered nothing"
    else:
        assert stats["batched_dispatches"] > 0
