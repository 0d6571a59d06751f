"""The HierFAVG-family baselines of the port against the JAX package's, both
on the CPU: two rounds of each from the JAX trainer's global parameters
(converted) and the same data, ``_quantize`` and
``aggregate_params`` on the same inputs, the interaction protocols, the
fault hook and the participation mask.

Tiny config: ``tests/test_torch_fedeec.py``'s (8 samples a client, 8x8
images, batch 8, cnn1 on every node) with 4 clients under 2 edges, so that
the edge and cloud aggregations both average more than one model and
DemLearn's re-clustering has two edges to choose from. Tolerances: params
within 1e-4 (fp32 convolutions in another order through AdamW steps, as
the FedEEC round's bound), the numpy generator's state and the comm bytes
equal, accuracy within one test sample, ``_quantize`` bit for bit,
``aggregate_params`` within one fp32 ulp of each element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JConfig
from repro.core.protocols import aggregate_params as j_aggregate_params
from repro.core.topology import Tree as JTree
from repro.data.partition import dirichlet_partition
from repro.data.synthetic import make_dataset
from repro.fl import baselines as jb
from repro.fl.api import create_algorithm as j_create_algorithm
from repro.fl.metrics import accuracy as jax_accuracy
from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core.protocols import (
    BSBODP_SKR,
    PARAM_AVG,
    PARTIAL_TRAIN,
    aggregate_params,
    is_submodel,
    same_structure,
)
from repro_torch.core.topology import Tree
from repro_torch.fl import baselines as tb
from repro_torch.fl.api import (
    FLAlgorithm,
    MigrationRefused,
    WorkItem,
    create_algorithm,
)
from repro_torch.fl.engine import build_problem
from repro_torch.fl.metrics import accuracy
from repro_torch.tree import tree_leaves

TINY = dict(num_clients=4, num_edges=2, samples_per_client=8, test_samples=64,
            image_size=8, embed_dim=16, distill_steps=1)
PARAM_TOL = 1e-4
# the registry entries' knobs (reference baselines.py:312-336)
KNOBS = {"hierfavg": {}, "hiermo": {"momentum": 0.9}, "hierqsgd": {"quantize": True},
         "demlearn": {"self_organize": True}}
ALGORITHMS = sorted(KNOBS) + ["fedavg"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a worker: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data():
    ds = make_dataset("synth_cifar10", num_train=32, num_test=64, image=8, seed=0)
    parts = dirichlet_partition(ds.y_train, 4, 2.0, seed=0)
    data = {f"client{i}": (ds.x_train[parts[i]], ds.y_train[parts[i]]) for i in range(4)}
    return ds, data


def _pair(name: str):
    """(JAX trainer, port trainer) of baseline ``name``, the port's starting
    from the JAX trainer's global params."""
    jcfg, tcfg = JConfig(**TINY), FLConfig(**TINY)
    ds, data = _data()
    if name == "fedavg":
        jt = jb.FlatFedAvg(jcfg, data, seed=0)
        params = convert.from_jax("cnn1", _np(jt.global_params))
        tt = tb.FlatFedAvg(tcfg, data, seed=0, device="cpu", params=params)
    else:
        jt = jb.HierarchicalFedAvg(jcfg, JTree.three_tier(2, 4), data, seed=0, **KNOBS[name])
        params = convert.from_jax("cnn1", _np(jt.global_params))
        tt = tb.HierarchicalFedAvg(tcfg, Tree.three_tier(2, 4), data, seed=0, device="cpu",
                                   params=params, **KNOBS[name])
    return jt, tt, ds


def _max_diff(want_jax, got_torch):
    want = jax.tree.leaves(_np(want_jax))
    got = jax.tree.leaves(convert.to_jax("cnn1", got_torch))
    assert [a.shape for a in want] == [b.shape for b in got]
    return max(float(np.abs(a - b).max()) for a, b in zip(want, got))


@pytest.mark.parametrize("name", ALGORITHMS)
def test_rounds_match_jax(name):
    """Two rounds (the second on persisted AdamW states and, for HierMo,
    the momentum buffer): global params, optimizer moments, momentum, the
    generator's state, comm bytes, topology and cloud accuracy."""
    jt, tt, ds = _pair(name)
    assert tt._nfloats == jt._nfloats
    for _ in range(2):
        jt.train_round()
        tt.train_round()
    worst = _max_diff(jt.global_params, tt.global_params)
    for v in jt.opt:
        assert int(tt.opt[v]["step"]) == int(jt.opt[v]["step"]) == 2
        worst = max(worst, _max_diff(jt.opt[v]["m"], tt.opt[v]["m"]))
    if name == "hiermo":
        worst = max(worst, _max_diff(jt._momentum_buf, tt._momentum_buf))
    print(f"{name}: params, moments (and momentum) max|diff| after two rounds {worst:.3e}")
    assert worst < PARAM_TOL, worst
    assert tt.rng.bit_generator.state == jt.rng.bit_generator.state
    assert dict(tt.comm.bytes) == dict(jt.comm.bytes)
    assert dict(tt.tree.parent) == dict(jt.tree.parent)
    ja = jax_accuracy(jt.cloud_apply(), jt.cloud_params(), ds.x_test, ds.y_test)
    ta = accuracy(tt.cloud_apply(), tt.cloud_params(), ds.x_test, ds.y_test)
    assert abs(ta - ja) <= 1 / len(ds.y_test) + 1e-12, (ta, ja)


@pytest.mark.parametrize("name", ALGORITHMS)
def test_registry_builds_the_references_variants(name):
    cfg = FLConfig(**TINY)
    _, data = _data()
    jt = j_create_algorithm(name, JConfig(**TINY), JTree.three_tier(2, 4), data, None)
    tt = create_algorithm(name, cfg, Tree.three_tier(2, 4), data, None, device="cpu")
    assert type(tt).__name__ == type(jt).__name__
    for knob in ("momentum", "quantize", "self_organize", "kappa1", "kappa2"):
        assert getattr(tt, knob) == getattr(jt, knob), knob
    assert tt.protocol is PARAM_AVG and tt.batch_signature(WorkItem("local", "client0")) is None
    assert sorted(tt.tree.nodes) == sorted(jt.tree.nodes)


def test_quantize_is_bit_identical_to_the_references():
    """One delta in the reference's layout (cnn1's tree, nested dicts with
    keys out of sorted order), through both ``_quantize`` from generators in
    one state: equal bits, equal generator states after."""
    rng = np.random.default_rng(5)
    params = _np(jb.get_fl_model("cnn1")[0](jax.random.PRNGKey(0), 10, 8))
    delta = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), params)
    reordered = {k: delta[k] for k in sorted(delta, reverse=True)}
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    want = _np(jb._quantize(jax.tree.map(jnp.asarray, delta), rng=r1))
    got = tb._quantize(reordered, rng=r2)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    assert r1.bit_generator.state == r2.bit_generator.state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aggregate_params_matches_the_references(dtype):
    """Three random trees (a dict with a list), weights of mixed types:
    within one fp32 ulp of the reference's element (bf16: the same bf16
    value, as both round one fp32 sum)."""
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 7), "b": (7,), "blocks": [(3, 3), (4,)]}
    trees = [jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple)) for _ in range(3)]
    weights = [3, 17.5, 8]
    jt = [jax.tree.map(lambda a: jnp.asarray(a, dtype), t) for t in trees]
    want = jax.tree.leaves(j_aggregate_params(jt, weights))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tt = [jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), t) for t in trees]
    got = jax.tree.leaves(aggregate_params(tt, weights))
    worst = 0.0
    for a, b in zip(want, got):
        assert b.dtype == tdt
        a32 = np.asarray(a, np.float32)
        b32 = b.float().numpy()
        ulp = np.spacing(np.abs(a32).astype(np.float32))
        worst = max(worst, float((np.abs(a32 - b32) / ulp).max()))
    print(f"aggregate_params {dtype}: max |diff| {worst:.3f} fp32 ulp of the reference's")
    assert worst <= 1.0


def test_cohort_weights_are_bitwise_exact_fedavg():
    """As ``tests/test_simcore.py``: (m·n_i)/(m·S) == n_i/S exactly, so
    cohort-scaled integer weights aggregate bit for bit as the plain ones."""
    params = [{"w": torch.arange(6, dtype=torch.float32) * (i + 1) / 3.0,
               "b": torch.full((2,), float(i))} for i in range(4)]
    counts = [32, 17, 8, 3]
    solo = aggregate_params(params, counts)
    cohort = aggregate_params(params, [25_000 * n for n in counts])
    for k in solo:
        assert torch.equal(solo[k], cohort[k])


# ----------------------------------------------------- protocols (§IV-E)


def test_protocol_kinds():
    a = {"w": np.zeros((4, 4))}
    b = {"w": np.zeros((8, 8))}
    assert same_structure(a, a) and not same_structure(a, b)
    assert not same_structure({"w": np.zeros(2)}, [np.zeros(2)])
    assert is_submodel(a, b) and not is_submodel(b, a)
    assert BSBODP_SKR.allows_migration(lambda v: a if v == "x" else b, "x", "y")
    assert PARAM_AVG.allows_migration(lambda v: a, "x", "y")
    assert not PARTIAL_TRAIN.allows_migration(lambda v: b if v == "x" else a, "x", "y")


def test_aggregate_params_weighted():
    a = {"w": torch.ones((2, 2))}
    b = {"w": 3 * torch.ones((2, 2))}
    assert torch.allclose(aggregate_params([a, b], [1.0, 3.0])["w"], torch.tensor(2.5))


def _small_cfg(**kw):
    base = dict(num_clients=4, num_edges=2, samples_per_client=16, test_samples=64,
                image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2")
    base.update(kw)
    return FLConfig(**base)


def _problem():
    cfg = _small_cfg()
    return (cfg,) + build_problem(cfg, device="cpu")


def test_equivalence_protocols_always_allow_migration():
    cfg, _, tree, client_data, auto = _problem()
    tr = create_algorithm("hierfavg", cfg, tree, client_data, auto, device="cpu")
    assert tr.protocol is PARAM_AVG
    assert tr.try_migrate("client0", "edge1")
    assert tr.tree.parent["client0"] == "edge1"
    tr.migrate("client0", "edge0")


def test_partial_order_protocol_refuses_illegal_move():
    """Client models (cnn1) are not sub-models of the edge's cnn2 in the
    port's layout either (Thm 2)."""
    cfg, _, tree, client_data, auto = _problem()
    tr = create_algorithm("fedeec", cfg, tree, client_data, auto, device="cpu")
    tr.protocol = PARTIAL_TRAIN
    refusals = []
    tr.on_migrate_refused(lambda n, t, why: refusals.append((n, t, why)))
    old_parent = tr.tree.parent["client0"]
    with pytest.raises(MigrationRefused):
        tr.migrate("client0", "edge1")
    assert tr.tree.parent["client0"] == old_parent
    assert refusals == [("client0", "edge1", "protocol")]
    assert tr.try_migrate("client0", "edge1") is False


def test_partial_order_without_model_params_refuses_not_crashes():
    class Bare(FLAlgorithm):
        protocol = PARTIAL_TRAIN

        def work_items(self, round, online):
            return []

        def execute(self, item):
            pass

        def cloud_params(self):
            return None

        def cloud_apply(self):
            return None

    tr = Bare(_small_cfg(), Tree.three_tier(2, 4))
    assert tr.try_migrate("client0", "edge1") is False
    assert tr.tree.parent["client0"] == "edge0"


def test_sim_logs_protocol_refusal_for_churn_and_trainer_moves():
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.scenarios import ScenarioConfig, TraceEntry

    cfg, _, tree, client_data, auto = _problem()
    tr = create_algorithm("fedeec", cfg, tree, client_data, auto, device="cpu")
    tr.protocol = PARTIAL_TRAIN
    sc = ScenarioConfig("forced_move",
                        trace=(TraceEntry(0, "migrate", "client0", target="edge1"),))
    eng = SimEngine(tr, sc, seed=0)
    eng.run(1)
    refused = [e for e in eng.log.entries if e["kind"] == "migrate_refused"]
    assert refused and refused[0]["reason"] == "protocol"
    assert refused[0]["node"] == "client0" and tr.tree.parent["client0"] == "edge0"
    assert tr.try_migrate("client2", "edge1") is False
    trainer_refused = [e for e in eng.log.entries
                       if e["kind"] == "migrate_refused" and e.get("source") == "trainer"]
    assert trainer_refused and trainer_refused[0]["node"] == "client2"


# --------------------------------------------- faults and participation


def test_hierfavg_drops_failed_client_from_weights():
    cfg, _, tree, client_data, auto = _problem()
    t = create_algorithm("hierfavg", cfg, tree, client_data, auto, device="cpu")
    t.begin_round(0)
    edge = tree.parent["client0"]
    for c in sorted(tree.children[edge]):
        t.execute(WorkItem("local", c, edge))
    staged = len(t._round_updates[edge])
    t.on_item_failed(WorkItem("local", "client0", edge), "abandoned")
    assert len(t._round_updates[edge]) == staged - 1
    assert all(c != "client0" for c, _ in t._round_updates[edge])
    t.on_item_failed(WorkItem("aggregate", edge, "cloud"), "timeout")
    assert t._edge_weight[edge] == 0.0 and edge not in t._edge_params


def test_participation_mask_changes_hierfavg_aggregate():
    cfg = _small_cfg()
    _, tree, cd, auto = build_problem(cfg, device="cpu")
    full = create_algorithm("hierfavg", cfg, tree, cd, auto, device="cpu")
    _, tree2, cd2, auto2 = build_problem(cfg, device="cpu")
    masked = create_algorithm("hierfavg", cfg, tree2, cd2, auto2, device="cpu")
    masked.set_participation({"client0", "client2", "client3"})
    assert masked.participates("client0") and not masked.participates("client1")
    assert masked.participates("edge0")
    full.train_round()
    masked.train_round()
    dist = sum(float((a - b).abs().sum()) for a, b in
               zip(tree_leaves(full.global_params), tree_leaves(masked.global_params)))
    assert dist > 0
    assert int(masked.opt["client1"]["step"]) == 0
    assert int(masked.opt["client0"]["step"]) > 0
    masked.set_participation(None)
    assert masked.participates("client1")


def test_clients_train_copies_of_the_global_model():
    """A local step updates its client's copy in place, never the global
    model the other clients of the round start from."""
    cfg, _, tree, client_data, auto = _problem()
    t = create_algorithm("hierfavg", cfg, tree, client_data, auto, device="cpu")
    before = [p.clone() for p in tree_leaves(t.global_params)]
    t.begin_round(0)
    t.execute(WorkItem("local", "client0", "edge0", link="end-edge"))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(t.global_params)))
    (_, p), = t._round_updates["edge0"]
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(p)))
