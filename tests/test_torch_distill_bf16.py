"""distill_loss on bf16 logits, as the LM training loss feeds it: the port's
ops (their plain versions, as they run on the CPU) against the JAX
package's ``repro.kernels.ops`` with the Pallas kernels in interpret mode.

Both sides read the same bf16 logits as fp32 and compute in fp32, so the
loss agrees within 1e-6 relative (sums in other orders) and is fp32; dz is
bf16 on both sides, each rounded once from nearly the same fp32 value, so
it agrees within one bf16 ulp of |want| (2^-7 |want|; a rounding flip at
most) and nothing more at beta = 0. With beta > 0, where beta's term nearly
cancels lw * p, the two fp32 values before rounding differ by the fp32
noise of the terms, not of their small sum (1.7% of an element of 8e-8 at
(37, 1000), beta = 1.5), which ``ref.distill_loss_grad_bf16_bound`` allows
as 2^-16 of each element's terms g beta p (|logZ| + |logp - t| + |KL|)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.distill_loss import distill_loss_batched

def _bf16(a: np.ndarray) -> tuple[np.ndarray, torch.Tensor]:
    """The same bf16 values as numpy (for JAX) and as a torch tensor."""
    b = a.astype(ml_dtypes.bfloat16)
    return b, torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)


def _inputs(N, V, seed=0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((N, V)) * 2.0).astype(np.float32)
    t = rng.standard_normal((N, V)).astype(np.float32)
    t = (t - np.log(np.exp(t).sum(-1, keepdims=True))).astype(np.float32)
    y = rng.integers(0, V, N).astype(np.int32)
    g = rng.standard_normal(N).astype(np.float32)
    return z, t, y, g


def _held(dz: torch.Tensor, want, z, t, beta, g) -> None:
    """dz (bf16) within one bf16 ulp of the JAX package's, plus at beta > 0
    the fp32 noise of the terms that beta's term cancels."""
    assert dz.dtype == torch.bfloat16
    w = torch.from_numpy(np.asarray(want).astype(np.float32))
    d = (dz.float() - w).abs()
    bound = R.distill_loss_grad_bf16_bound(w, z, t, beta, g=torch.from_numpy(g))
    assert (d <= bound).all(), (d / bound).max()


# (N, V): FedEEC's width, a vocabulary no multiple of 8 or of the Pallas
# kernel's 512-wide tile, one of a few tiles, and llama3.2-3b's padded
# vocabulary over a few rows
SHAPES = [(8, 10), (37, 1000), (5, 1003), (16, 2048), (3, 128256)]


@pytest.mark.parametrize("N,V", SHAPES)
def test_fused_softmax_xent_bf16_matches_pallas(N, V):
    z, _, y, g = _inputs(N, V)
    zj, zt = _bf16(z)
    want, vjp = jax.vjp(lambda a: jax_ops.fused_softmax_xent(a, jnp.asarray(y)),
                        jnp.asarray(zj))
    (want_dz,) = vjp(jnp.asarray(g))
    assert want_dz.dtype == jnp.bfloat16
    zt.requires_grad_(True)
    loss = ops.fused_softmax_xent(zt, torch.from_numpy(y).long())
    (dz,) = torch.autograd.grad(loss, zt, torch.from_numpy(g))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-6, atol=0)
    _held(dz, want_dz, zt, torch.zeros_like(zt), 0.0, g)


@pytest.mark.parametrize("N,V", SHAPES[:4])
@pytest.mark.parametrize("beta,lw", [(1.5, 1.0), (1.5, 0.5)])
def test_fused_distill_loss_bf16_matches_pallas(N, V, beta, lw):
    z, t, y, g = _inputs(N, V, seed=1)
    (zj, zt), (tj, tt) = _bf16(z), _bf16(t)
    want, vjp = jax.vjp(
        lambda a: jax_ops.fused_distill_loss(a, jnp.asarray(tj), jnp.asarray(y), beta=beta,
                                             label_weight=lw), jnp.asarray(zj))
    (want_dz,) = vjp(jnp.asarray(g))
    zt.requires_grad_(True)
    loss = ops.fused_distill_loss(zt, tt, torch.from_numpy(y).long(), beta=beta,
                                  label_weight=lw)
    (dz,) = torch.autograd.grad(loss, zt, torch.from_numpy(g))
    assert loss.dtype == torch.float32
    # the KL term is a difference of terms near logZ: 1e-6 of the largest
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(want)).max())
    _held(dz, want_dz, zt, tt, beta, g)


def test_batched_bf16_matches_pallas():
    from repro.kernels.distill_loss import distill_loss_batched as jax_batched

    z, t, y, g = _inputs(2 * 9, 300, seed=2)
    (zj, zt), (tj, tt) = _bf16(z.reshape(2, 9, 300)), _bf16(t.reshape(2, 9, 300))
    y, g = y.reshape(2, 9), g.reshape(2, 9)
    want, vjp = jax.vjp(lambda a: jax_batched(a, jnp.asarray(tj), jnp.asarray(y), 1.5, 1.0,
                                              True), jnp.asarray(zj))
    (want_dz,) = vjp(jnp.asarray(g))
    zt.requires_grad_(True)
    loss = distill_loss_batched(zt, tt, torch.from_numpy(y), 1.5, 1.0)
    (dz,) = torch.autograd.grad(loss, zt, torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(want)).max())
    _held(dz, want_dz, zt, tt, 1.5, g)


def test_plain_versions_read_bf16_as_fp32():
    """The loss of bf16 logits is the loss of their fp32 widening, bit for
    bit; dz is that fp32 gradient rounded once to bf16."""
    z, t, y, g = _inputs(6, 40, seed=3)
    (_, zt), (_, tt) = _bf16(z), _bf16(t)
    yt, gt = torch.from_numpy(y), torch.from_numpy(g)
    assert torch.equal(R.distill_loss_ref(zt, yt, tt, 1.5),
                       R.distill_loss_ref(zt.float(), yt, tt.float(), 1.5))
    dz = R.distill_loss_grad_ref(zt, yt, tt, 1.5, g=gt)
    wide = R.distill_loss_grad_ref(zt.float(), yt, tt.float(), 1.5, g=gt)
    assert dz.dtype == torch.bfloat16 and torch.equal(dz, wide.bfloat16())


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32),
                                    (torch.float16, torch.float16),
                                    (torch.float64, torch.float64)])
def test_other_dtypes_are_refused(dtypes):
    z = torch.zeros((1, 2, 8), dtype=dtypes[0])
    t = torch.zeros((1, 2, 8), dtype=dtypes[1])
    with pytest.raises(TypeError, match="fp32 or bf16"):
        distill_loss_batched(z, t, torch.zeros((1, 2), dtype=torch.long))


@pytest.mark.parametrize("beta", [0.0, 1.5])
def test_bound_rejects_zeros_for_small_elements(beta):
    """At llama3.2-3b's vocabulary most |dz| are below 1e-6; a backward that
    wrote 0 for them must fail the bound (an absolute 1e-6 would pass it)."""
    z, t, y, g = _inputs(4, 128256, seed=4)
    (_, zt), (_, tt) = _bf16(z), _bf16(t if beta else np.zeros_like(t))
    gt = torch.from_numpy(g)
    want = R.distill_loss_grad_ref(zt, torch.from_numpy(y), tt, beta, g=gt).float()
    small = want.abs() < 1e-6
    assert small.float().mean() > 0.3
    bad = torch.where(small, torch.zeros_like(want), want)
    bound = R.distill_loss_grad_bf16_bound(want, zt, tt, beta, g=gt)
    assert ((bad - want).abs() <= 2.0**-7 * want.abs() + 1e-6).all()
    assert not ((bad - want).abs() <= bound).all()
