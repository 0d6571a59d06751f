"""The chunked state-passing form of the RWKV6 recurrence, which
``csrc/rwkv6_scan_chunked.cu`` computes on the card for long sequences, as
its plain torch version ``ref.rwkv6_scan_chunked_ref`` runs it on the CPU:
held to the JAX package's Pallas kernel in interpret mode and to the port's
sequential ``ref.rwkv6_scan_ref``, at ragged T, chunks of 16 and 64, and
decays of exactly 1.0 and 1e-30 (where a log-space chunked form overflows).
All within 3e-5: fp32 sums in another order, as the JAX kernel tests allow.
Also the wrapper's rule for which kernel a CUDA call runs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import rwkv6_scan as K

B, H = 1, 2


@functools.lru_cache(maxsize=None)
def _inputs(T, hd, extreme):
    rng = np.random.default_rng(T * 131 + hd)
    shp = (B, T, H, hd)
    r, k, v = ((rng.standard_normal(shp) * 0.3).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal(shp)))).astype(np.float32)
    if extreme:
        w[:, ::7] = 1e-30  # every 7th step forgets the state
        w[:, 3::5, :, ::2] = 1.0  # half the rows of every 5th step keep it whole
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


@functools.lru_cache(maxsize=None)
def _pallas(T, hd, extreme):
    y, sT = pallas_rwkv6(*(jnp.asarray(a) for a in _inputs(T, hd, extreme)), chunk=64)
    return np.asarray(y), np.asarray(sT)


def _close(got, want, tol=3e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("extreme", [False, True], ids=["sigmoid_w", "extreme_w"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("T", [0, 1, 63, 64, 65, 200])
def test_chunked_matches_pallas_and_sequential(T, chunk, hd, extreme):
    ins = _inputs(T, hd, extreme)
    t = [torch.from_numpy(a) for a in ins]
    y, sT = R.rwkv6_scan_chunked_ref(*t, chunk)
    ry, rs = R.rwkv6_scan_ref(*t)
    assert y.dtype == torch.float32 and y.shape == (B, T, H, hd) and sT.shape == rs.shape
    assert torch.isfinite(y).all() and torch.isfinite(sT).all()
    _close(y, ry)
    _close(sT, rs)
    if T == 0:  # the Pallas call takes no empty time axis; the state is s0
        assert torch.equal(sT, t[-1])
        return
    want_y, want_s = _pallas(T, hd, extreme)
    _close(y, want_y)
    _close(sT, want_s)


@pytest.mark.parametrize("T,variant", [(0, "seq"), (1, "seq"), (16, "seq"), (17, "chunked"),
                                       (64, "chunked"), (1024, "chunked")])
def test_variant_by_sequence_length(T, variant):
    """Decode steps (T = 1) stay on the sequential kernel; a prefill of more
    than SEQ_MAX_T steps runs the chunked scan."""
    assert K.SEQ_MAX_T <= K.CHUNK
    assert K._variant(T) == variant


def test_cpu_tensors_launch_no_kernel():
    """On the CPU the op is the plain sequential version, whatever T: no
    kernel of either variant is counted."""
    ops.reset_launches()
    t = [torch.from_numpy(a) for a in _inputs(65, 16, False)]
    y, sT = ops.rwkv6_scan(*t)
    ry, rs = R.rwkv6_scan_ref(*t)
    assert torch.equal(y, ry) and torch.equal(sT, rs)
    assert K.variant_launches == {"seq": 0, "chunked": 0}
    assert ops.launches["rwkv6_scan"] == 0



@pytest.mark.parametrize("T,hd", [(64, 64), (256, 64), (130, 128)])
def test_chunked_and_sequential_are_fp32_noise_from_fp64(T, hd):
    """ROADMAP C13: rwkv6-1.6b's two-layer training parity, with parameters
    drawn on the card, reads 1.0e-4 of max|g| through the chunked forward
    kernel and 4.4e-5 through the sequential plain forward, while its CPU
    result moves 5.3e-5 with the thread count alone: the forward's
    association sets the spread, and the model amplifies fp32 noise. Both
    associations stay fp32 noise away from the recurrence in fp64 (within
    1e-6 of max|y|), the chunked one (the kernel's algorithm) no further
    than four times the sequential one, so neither is at fault."""
    t = tuple(torch.from_numpy(a) for a in _inputs(T, hd, False))
    y64 = R.rwkv6_scan_ref(*t, dtype=torch.float64)[0]
    scale = y64.abs().max().item()
    seq = (R.rwkv6_scan_ref(*t)[0].double() - y64).abs().max().item() / scale
    chunked = (R.rwkv6_scan_chunked_ref(*t, 64)[0].double() - y64).abs().max().item() / scale
    assert seq <= 1e-6 and chunked <= 1e-6
    assert chunked <= 4 * seq + 1e-7
