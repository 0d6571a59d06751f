"""The port's BSBODP losses (through the fused distill_loss op) against the
JAX package's jnp losses: values and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsbodp as J
from repro_torch.core import bsbodp as T


def _inputs(N=8, C=10, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((N, C)) * scale).astype(np.float32)
    zl = (rng.standard_normal((N, C)) * scale).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    yl = rng.integers(0, C, N).astype(np.int32)
    q = rng.random((N, C)) ** 3
    q[0, 1] = 0.0  # exercises the 1e-12 clamp on the teacher
    q = (q / q.sum(-1, keepdims=True)).astype(np.float32)
    return z, zl, y, yl, q


def _pin_tiny_gold(z, y):
    """Make row 0's gold probability < 1e-12 (CE above -log 1e-12)."""
    z = z.copy()
    z[0, :] = 0.0
    z[0, y[0]] = -40.0
    return z


# within 1e-6: fp32 CE + β·KL summed in another order (logsumexp and the
# fused op against log of softmax), mean over 8 rows
@pytest.mark.parametrize("pin", [False, True])
def test_non_leaf_loss_and_grad(pin):
    z, _, y, _, q = _inputs(seed=1)
    if pin:
        z = _pin_tiny_gold(z, y)
    beta = 1.5
    jl, jg = jax.value_and_grad(lambda zz: J.non_leaf_loss(zz, jnp.asarray(y), jnp.asarray(q), beta))(
        jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    tl = T.non_leaf_loss(zt, torch.from_numpy(y), torch.from_numpy(q), beta)
    (tg,) = torch.autograd.grad(tl, zt)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    if pin:
        # the reference's clamp caps the row's CE and zeroes its CE gradient
        assert float(jl) < 100.0


@pytest.mark.parametrize("pin", [False, True])
def test_leaf_loss_and_grad(pin):
    z, zl, y, yl, q = _inputs(seed=2)
    if pin:
        z = _pin_tiny_gold(z, y)
    beta, gamma = 1.5, 0.7

    def jf(a, b):
        return J.leaf_loss(a, jnp.asarray(yl), b, jnp.asarray(y), jnp.asarray(q), beta, gamma)

    jl, (jga, jgb) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(zl), jnp.asarray(z))
    a = torch.from_numpy(zl).requires_grad_(True)
    b = torch.from_numpy(z).requires_grad_(True)
    tl = T.leaf_loss(a, torch.from_numpy(yl), b, torch.from_numpy(y), torch.from_numpy(q),
                     beta, gamma)
    tga, tgb = torch.autograd.grad(tl, (a, b))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tga.numpy(), np.asarray(jga), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tgb.numpy(), np.asarray(jgb), rtol=0, atol=1e-6)


def test_plain_helpers_match():
    z, _, y, _, q = _inputs(seed=3)
    sp = jax.nn.softmax(jnp.asarray(z), -1)
    tsp = torch.softmax(torch.from_numpy(z), -1)
    np.testing.assert_allclose(
        float(T.softmax_ce_with_probs(tsp, torch.from_numpy(y))),
        float(J.softmax_ce_with_probs(sp, jnp.asarray(y))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(T.kl_div(tsp, torch.from_numpy(q))), float(J.kl_div(sp, jnp.asarray(q))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(T.softmax_xent(torch.from_numpy(z), torch.from_numpy(y))),
        float(J.softmax_xent(jnp.asarray(z), jnp.asarray(y))), rtol=0, atol=1e-6)
    apply_t = lambda p, x: x @ p
    w = np.random.default_rng(4).standard_normal((10, 10)).astype(np.float32)
    tz, tp = T.extract_knowledge(apply_t, torch.from_numpy(w), torch.from_numpy(z), 0.5)
    jz, jp = J.extract_knowledge(lambda p, x: x @ p, jnp.asarray(w), jnp.asarray(z), 0.5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_ce_cap_is_reference_clamp():
    assert T.CE_CAP == pytest.approx(float(-jnp.log(jnp.float32(1e-12))), abs=0)
