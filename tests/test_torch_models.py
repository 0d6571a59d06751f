"""The port's FL models and autoencoder against the JAX package's, from the
same (converted) parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import autoencoder as JA
from repro.models.registry import get_fl_model as jax_model
from repro_torch import convert
from repro_torch.models import autoencoder as TA
from repro_torch.models.cnn import conv
from repro_torch.models.registry import get_fl_model

KEY = jax.random.PRNGKey(0)


def _images(n, image, seed=0):
    return np.random.default_rng(seed).random((n, image, image, 3), dtype=np.float32)


# logits within 1e-5: fp32 convolutions and GroupNorm reductions summed in
# another order (measured max about 2e-6 for resnet18)
@pytest.mark.parametrize("name", ["cnn1", "cnn2", "resnet10", "resnet18"])
@pytest.mark.parametrize("image", [16, 8])
def test_logits_match_jax(name, image):
    init, apply = jax_model(name)
    p = init(jax.random.fold_in(KEY, image), 10, image)
    x = _images(6, image)
    want = np.asarray(apply(p, jnp.asarray(x)))
    tp = convert.from_jax(name, jax.tree.map(np.asarray, p))
    got = get_fl_model(name)[1](tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("image", [16, 8])
def test_autoencoder_matches_jax(image):
    p = JA.init_autoencoder(KEY, image=image, embed_dim=32)
    tp = convert.from_jax("autoencoder", jax.tree.map(np.asarray, p))
    x = _images(5, image, seed=1)
    e_want = np.asarray(JA.encode(p, jnp.asarray(x)))
    e_got = TA.encode(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(e_got, e_want, rtol=0, atol=1e-5)
    d_want = np.asarray(JA.decode(p, jnp.asarray(e_want), image))
    d_got = TA.decode(tp, torch.from_numpy(e_want), image).numpy()
    assert d_got.shape == d_want.shape == (5, image, image, 3)
    np.testing.assert_allclose(d_got, d_want, rtol=0, atol=1e-5)


def test_stride2_same_padding_is_asymmetric():
    """XLA pads a stride-2 3x3 SAME conv on an even input by (0, 1); a
    symmetric padding of 1 gives the same shape and different values."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = conv(xt, wt, stride=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    sym = torch.nn.functional.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    assert np.abs(sym - want).max() > 1e-2


def test_pretrain_reduces_reconstruction_error():
    x = _images(32, 8, seed=3)
    xt = torch.from_numpy(x)

    def mse(p):
        return float(torch.mean((TA.decode(p, TA.encode(p, xt), 8) - xt) ** 2))

    init = TA.init_autoencoder(torch.Generator().manual_seed(7), image=8, embed_dim=16)
    trained = TA.pretrain_autoencoder(7, x, image=8, embed_dim=16, steps=40,
                                      batch=16, device="cpu")
    assert mse(trained) < mse(init)
