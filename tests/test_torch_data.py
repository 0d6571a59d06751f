"""The port's copies of the numpy-only modules give the JAX package's
arrays bit for bit."""
import numpy as np
import pytest

from repro.core.topology import Tree as JTree
from repro.data.partition import dirichlet_partition as jax_partition
from repro.data.synthetic import make_dataset as jax_dataset
from repro.fl.comm import CommMeter as JCommMeter
from repro_torch.core.topology import Tree, link_kind
from repro_torch.data.partition import dirichlet_partition, iid_partition
from repro_torch.data.synthetic import make_dataset
from repro_torch.fl.comm import CommMeter


@pytest.mark.parametrize("name", ["synth_svhn", "synth_cifar10", "synth_cinic10"])
def test_make_dataset_identical(name):
    kw = dict(num_train=96, num_test=32, num_open=16, image=8, num_classes=10, seed=3)
    a, b = make_dataset(name, **kw), jax_dataset(name, **kw)
    for f in ("x_train", "y_train", "x_test", "y_test", "x_open"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("clients,alpha,seed", [(20, 2.0, 0), (7, 0.1, 5)])
def test_dirichlet_partition_identical(clients, alpha, seed):
    labels = np.random.default_rng(seed).integers(0, 10, 400).astype(np.int32)
    got = dirichlet_partition(labels, clients, alpha, seed=seed)
    want = jax_partition(labels, clients, alpha, seed=seed)
    assert len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert sum(len(p) for p in iid_partition(50, 4)) == 50


def test_topology_and_comm_copies_agree():
    t, jt = Tree.three_tier(3, 7), JTree.three_tier(3, 7)
    assert list(t.post_order()) == list(jt.post_order())
    assert [link_kind(t, v) for v in t.nodes if v != t.root] == [
        link_kind(jt, v) for v in jt.nodes if v != jt.root]
    t.migrate("client0", "edge2")
    jt.migrate("client0", "edge2")
    assert t.children == jt.children
    m, jm = CommMeter(), JCommMeter()
    for meter in (m, jm):
        meter.record("end-edge", 12)
        with meter.span() as sp:
            meter.record("edge-cloud", 3.5)
    assert m.summary() == jm.summary() and sp.by_link == {"edge-cloud": 14.0}
