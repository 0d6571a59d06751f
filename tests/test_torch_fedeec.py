"""The slice end to end: one FedEEC round of the port against one round of
the JAX trainer, both on the CPU, from the same parameters and data.

Tiny config: 2 clients, 1 edge, 8 samples each, 8x8 images, embed 16,
one distill step per direction; models cnn1 / resnet10 / resnet18. The
autoencoder is ``repro.models.autoencoder.init_autoencoder`` without
pretraining (converted), and every node starts from the JAX trainer's
parameters (converted). ``tests/test_torch_fedagg.py`` runs the same
comparison with SKR off.
"""
import jax
import numpy as np

from repro.configs.base import FLConfig as JConfig
from repro.core.fedeec import FedEEC as JFedEEC
from repro.core.topology import Tree as JTree
from repro.data.partition import dirichlet_partition
from repro.data.synthetic import make_dataset
from repro.fl.metrics import accuracy as jax_accuracy
from repro.models.autoencoder import init_autoencoder
from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core.fedeec import FedEEC
from repro_torch.core.topology import Tree
from repro_torch.fl.metrics import accuracy

TINY = dict(num_clients=2, num_edges=1, samples_per_client=8, test_samples=64,
            image_size=8, embed_dim=16, distill_steps=1)
# params within 1e-4: fp32 convolutions in another order, through a few
# AdamW steps (measured max about 5e-6)
PARAM_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def run_one_round(use_skr: bool):
    """Both trainers after one round, plus the test split."""
    jcfg, tcfg = JConfig(**TINY), FLConfig(**TINY)
    ds = make_dataset(jcfg.dataset, num_train=16, num_test=64, image=8, seed=0)
    parts = dirichlet_partition(ds.y_train, 2, jcfg.dirichlet_alpha, seed=0)
    data = {f"client{i}": (ds.x_train[parts[i]], ds.y_train[parts[i]]) for i in range(2)}
    auto = init_autoencoder(jax.random.PRNGKey(3), image=8, embed_dim=16)
    jt = JFedEEC(jcfg, JTree.three_tier(1, 2), data, auto, use_skr=use_skr, seed=0)
    params = {v: convert.from_jax(jt.model_of[v], _np(jt.params[v])) for v in jt.params}
    tt = FedEEC(tcfg, Tree.three_tier(1, 2), data, convert.from_jax("autoencoder", _np(auto)),
                use_skr=use_skr, seed=0, device="cpu", params=params)
    jt.train_round()
    tt.train_round()
    return jt, tt, ds


def check_round_parity(jt, tt, ds):
    worst = 0.0
    for v in jt.params:
        want = jax.tree.leaves(_np(jt.params[v]))
        got = jax.tree.leaves(convert.to_jax(jt.model_of[v], tt.params[v]))
        worst = max(worst, max(float(np.abs(a - b).max()) for a, b in zip(want, got)))
        for k in ("count", "head"):
            assert np.array_equal(tt.skr[v][k].numpy(), np.asarray(jt.skr[v][k])), (v, k)
    assert worst < PARAM_TOL, worst
    assert dict(tt.comm.bytes) == dict(jt.comm.bytes)
    assert tt.rng.bit_generator.state == jt.rng.bit_generator.state
    ja = jax_accuracy(jt.cloud_apply(), jt.cloud_params(), ds.x_test, ds.y_test)
    ta = accuracy(tt.cloud_apply(), tt.cloud_params(), ds.x_test, ds.y_test)
    # identical, or one test sample apart on a near-tie of the argmax
    assert abs(ta - ja) <= 1 / len(ds.y_test) + 1e-12, (ta, ja)
    return worst


def test_fedeec_round_matches_jax():
    jt, tt, ds = run_one_round(use_skr=True)
    print(f"fedeec: params max|diff| after one round {check_round_parity(jt, tt, ds):.3e}")
    # the SKR queues saw pushes, so the comparison covered them
    assert sum(int(tt.skr[v]["count"].sum()) for v in tt.skr) > 0
