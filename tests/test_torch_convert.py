"""The JAX <-> port parameter converter: round trips are bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.autoencoder import init_autoencoder
from repro.models.registry import get_fl_model
from repro.optim import adamw_init, adamw_update
from repro_torch import convert

KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


def _params(name, image=16):
    if name == "autoencoder":
        return init_autoencoder(KEY, image=image, embed_dim=32)
    return get_fl_model(name)[0](KEY, 10, image)


# the image size shapes the flattened fc of the CNNs and the autoencoder;
# the ResNets pool globally
@pytest.mark.parametrize("name,image", [
    ("cnn1", 16), ("cnn1", 8), ("cnn2", 16), ("cnn2", 8), ("resnet10", 16),
    ("resnet18", 16), ("autoencoder", 16), ("autoencoder", 8)])
def test_params_round_trip_bit_exact(name, image):
    p = _np(_params(name, image))
    _assert_same(convert.to_jax(name, convert.from_jax(name, p)), p)


def test_conv_and_flatten_layouts():
    p = _np(_params("cnn1"))
    t = convert.from_jax("cnn1", p)
    # HWIO (3, 3, 3, 8) -> OIHW (8, 3, 3, 3)
    assert tuple(t["c1"].shape) == (8, 3, 3, 3)
    assert np.array_equal(t["c1"].numpy()[5, 2, 0, 1], p["c1"][0, 1, 2, 5])
    # fc rows (H, W, C) -> (C, H, W): row (h=1, w=0, c=3) of a 2x2x32 map
    H = W = 2
    C = 32
    assert np.array_equal(t["fc"]["w"].numpy()[3 * H * W + 1 * W + 0],
                          p["fc"]["w"][1 * W * C + 0 * C + 3])


@pytest.mark.parametrize("name", ["cnn1", "resnet18", "autoencoder"])
def test_adamw_state_round_trip_bit_exact(name):
    p = _params(name)
    opt = adamw_init(p)
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.3), p)
    p, opt = jax.jit(lambda g, o, p: adamw_update(g, o, p, lr=1e-3))(g, opt, p)
    state = _np(opt)
    back = convert.adamw_to_jax(name, convert.adamw_from_jax(name, state))
    _assert_same(back, state)
