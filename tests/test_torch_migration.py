"""Dynamic migration (§IV-E) in the port against the JAX trainer: the
embedding stores are rebuilt along the two affected root paths and the
re-registration upload is charged the same bytes."""
import jax
import numpy as np

from repro.configs.base import FLConfig as JConfig
from repro.core.fedeec import FedEEC as JFedEEC
from repro.core.topology import Tree as JTree
from repro.data.partition import dirichlet_partition
from repro.data.synthetic import make_dataset
from repro.models.autoencoder import init_autoencoder
from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core.fedeec import FedEEC
from repro_torch.core.topology import Tree

TINY = dict(num_clients=4, num_edges=2, samples_per_client=6, test_samples=8,
            image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2")


def test_migration_matches_jax():
    ds = make_dataset("synth_cifar10", num_train=24, num_test=8, image=8, seed=1)
    parts = dirichlet_partition(ds.y_train, 4, 2.0, seed=1)
    data = {f"client{i}": (ds.x_train[parts[i]], ds.y_train[parts[i]]) for i in range(4)}
    auto = init_autoencoder(jax.random.PRNGKey(5), image=8, embed_dim=16)
    jt = JFedEEC(JConfig(**TINY), JTree.three_tier(2, 4), data, auto)
    tt = FedEEC(FLConfig(**TINY), Tree.three_tier(2, 4), data,
                convert.from_jax("autoencoder", jax.tree.map(np.asarray, auto)),
                device="cpu")
    assert jt.try_migrate("client0", "edge1") and tt.try_migrate("client0", "edge1")
    assert tt.tree.children == jt.tree.children
    assert dict(tt.comm.bytes) == dict(jt.comm.bytes)
    for v, (e, y) in jt.embeddings.items():
        te, ty = tt.embeddings[v]
        assert np.array_equal(ty, y), v
        # the two encoders' fp32 convolutions differ in the last bits
        np.testing.assert_allclose(te, e, rtol=0, atol=1e-6)
