"""The port's kernel functions (their plain versions, as they run on the
CPU) against the JAX package's Pallas kernels run in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.distill_loss import distill_loss_batched as jax_distill_batched
from repro.kernels.skr_rectify import skr_rectify_batched as jax_skr_batched
from repro_torch.kernels import ops
from repro_torch.kernels.distill_loss import distill_loss, distill_loss_batched
from repro_torch.kernels.skr_rectify import (
    skr_rectify,
    skr_rectify_batched,
    skr_rectify_rows,
)


def _distill_inputs(B, N, V, seed=0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((B, N, V)) * 2.0).astype(np.float32)
    t = rng.standard_normal((B, N, V)).astype(np.float32)
    t = (t - np.log(np.exp(t).sum(-1, keepdims=True))).astype(np.float32)
    y = rng.integers(0, V, (B, N)).astype(np.int32)
    g = rng.standard_normal((B, N)).astype(np.float32)
    return z, t, y, g


# fwd within 1e-5: both sides sum in fp32 in different orders (the Pallas
# kernel online over 512-wide vocab tiles, the plain version through
# logsumexp); grad within 1e-6, the fp32 rounding of p·(z - logZ - t) terms
# of magnitude below ~5.
@pytest.mark.parametrize("B,N,V", [(1, 8, 10), (3, 5, 37), (3, 13, 700)])
@pytest.mark.parametrize("beta,lw", [(0.0, 1.0), (1.5, 1.0), (1.5, 0.5)])
def test_distill_loss_batched_matches_pallas(B, N, V, beta, lw):
    z, t, y, g = _distill_inputs(B, N, V)
    want, vjp = jax.vjp(
        lambda zz: jax_distill_batched(zz, jnp.asarray(t), jnp.asarray(y),
                                       beta, lw, True), jnp.asarray(z))
    (want_dz,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_(True)
    out = distill_loss_batched(zt, torch.from_numpy(t), torch.from_numpy(y),
                               beta, lw)
    (dz,) = torch.autograd.grad(out, zt, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(dz.numpy(), np.asarray(want_dz), rtol=0,
                               atol=1e-6)


def test_distill_loss_2d_is_batch_slice():
    z, t, y, _ = _distill_inputs(1, 9, 33, seed=1)
    zt, tt, yt = (torch.from_numpy(a) for a in (z, t, y))
    two_d = distill_loss(zt[0], tt[0], yt[0], 1.5, 1.0)
    batched = distill_loss_batched(zt, tt, yt, 1.5, 1.0)[0]
    assert torch.equal(two_d, batched)


def test_fused_softmax_xent_is_cross_entropy():
    z, _, y, _ = _distill_inputs(1, 16, 10, seed=2)
    zt, yt = torch.from_numpy(z[0]), torch.from_numpy(y[0]).long()
    got = ops.fused_softmax_xent(zt, yt)
    want = torch.nn.functional.cross_entropy(zt, yt, reduction="none")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _skr_inputs(B, N, C, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, N, C)) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, C, (B, N)).astype(np.int32)
    qbar = rng.uniform(0.1, 0.9, (B, C)).astype(np.float32)
    counts = rng.integers(0, 3, (B, C)).astype(np.int32)
    return probs.astype(np.float32), labels, qbar, counts


# exact: the map is a division and a product per element in the same
# expression order on both sides
@pytest.mark.parametrize("B,N,C", [(1, 8, 10), (3, 8, 10), (2, 13, 257)])
def test_skr_rectify_batched_matches_pallas_exactly(B, N, C):
    probs, labels, qbar, counts = _skr_inputs(B, N, C)
    want = np.asarray(jax_skr_batched(
        jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(qbar),
        jnp.asarray(counts), interpret=True))
    got = skr_rectify_batched(*(torch.from_numpy(a) for a in
                                (probs, labels, qbar, counts)))
    assert np.array_equal(got.numpy(), want)
    # the 2-D entry point is the B=1 slice
    got2 = skr_rectify(*(torch.from_numpy(a[0]) for a in
                         (probs, labels, qbar, counts)))
    assert np.array_equal(got2.numpy(), want[0])


def test_skr_rectify_rows_rejects_bad_inputs():
    p = torch.full((4, 10), 0.1)
    y = torch.zeros(4, dtype=torch.int64)
    ok = dict(p_c=torch.full((4,), 0.1), do=torch.ones(4, dtype=torch.bool),
              qb=torch.full((4,), 0.5))
    with pytest.raises(TypeError):
        skr_rectify_rows(p.double(), y, **ok)
    with pytest.raises(TypeError):
        skr_rectify_rows(p, y, ok["p_c"], ok["do"].int(), ok["qb"])
    with pytest.raises(ValueError):
        skr_rectify_rows(p, y[:3], **ok)


def test_distill_loss_rejects_bad_inputs():
    z = torch.zeros(1, 4, 10)
    y = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(TypeError):
        distill_loss_batched(z.double(), z.double(), y)
    with pytest.raises(ValueError):
        distill_loss_batched(z, z[:, :3], y)


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    z, t, y, _ = _distill_inputs(2, 4, 10)
    zt = torch.from_numpy(z).requires_grad_(True)
    distill_loss_batched(zt, torch.from_numpy(t), torch.from_numpy(y)).sum().backward()
    probs, labels, qbar, counts = _skr_inputs(1, 4, 10)
    skr_rectify_batched(*(torch.from_numpy(a) for a in (probs, labels, qbar, counts)))
    assert all(v == 0 for v in ops.launches.values())
