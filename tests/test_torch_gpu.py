"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and nvcc (they build the kernels at first use);
without a card they skip. Run them on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX: the card's machine has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.distill_loss import distill_loss_batched
from repro_torch.kernels.skr_rectify import skr_rectify_batched, skr_rectify_rows

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _distill_inputs(B, N, V, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((B, N, V), generator=g, device=dev) * 2.0
    t = torch.log_softmax(torch.randn((B, N, V), generator=g, device=dev), -1)
    y = torch.randint(0, V, (B, N), generator=g, device=dev)
    w = torch.randn((B, N), generator=g, device=dev)
    return z, t, y, w


def test_kernels_build_for_sm90a(cuda):
    _, report = _lib.build()
    assert "sm_90a" in report
    assert _lib.lib() is not None


# forward within 1e-5 relative: fp32 sums in another order. Gradient within
# 1e-6 absolute plus 1e-5 relative: the two sides' logZ may differ by one
# fp32 ulp (about 1e-6 at logZ ~ 10), which moves every dz element by that
# relative amount, and the largest elements reach a few units here
@pytest.mark.parametrize("B,N,V", [(1, 8, 10), (4, 8, 10), (3, 37, 1000),
                                   (4, 256, 2048), (2, 64, 128256)])
@pytest.mark.parametrize("beta", [0.0, 1.5])
def test_distill_loss_matches_plain(cuda, B, N, V, beta):
    z, t, y, w = _distill_inputs(B, N, V, cuda)
    zk = z.clone().requires_grad_(True)
    loss = distill_loss_batched(zk, t, y, beta, 1.0)
    (dz,) = torch.autograd.grad(loss, zk, w)
    want = R.distill_loss_batched_ref(z, y, t, beta, 1.0)
    want_dz = w[..., None] * R.distill_loss_grad_ref(z, y, t, beta, 1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dz, want_dz, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,N,C", [(1, 8, 10), (4, 8, 10), (4, 256, 1024)])
def test_skr_rectify_exact(cuda, B, N, C):
    g = torch.Generator(device=cuda).manual_seed(1)
    probs = torch.softmax(torch.randn((B, N, C), generator=g, device=cuda) * 2, -1)
    labels = torch.randint(0, C, (B, N), generator=g, device=cuda)
    qbar = torch.rand((B, C), generator=g, device=cuda) * 0.8 + 0.1
    counts = torch.randint(0, 3, (B, C), generator=g, device=cuda, dtype=torch.int32)
    got = skr_rectify_batched(probs, labels, qbar, counts)
    want = R.skr_rectify_batched_ref(probs, labels, qbar, counts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_launches_are_counted(cuda):
    ops.reset_launches()
    z, t, y, _ = _distill_inputs(1, 8, 10, cuda)
    zk = z.clone().requires_grad_(True)
    distill_loss_batched(zk, t, y, 1.5, 1.0).sum().backward()
    probs = torch.softmax(z, -1)
    skr_rectify_rows(probs[0], y[0], probs[0, :, 0].contiguous(),
                     torch.ones(8, dtype=torch.bool, device=cuda),
                     torch.full((8,), 0.5, device=cuda))
    assert ops.launches == {"distill_loss_fwd": 1, "distill_loss_bwd": 1, "skr_rectify": 1}


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    z, t, y, _ = _distill_inputs(1, 8, 16, cuda)
    with pytest.raises(ValueError):  # non-contiguous logits
        distill_loss_batched(z.transpose(1, 2).contiguous().transpose(1, 2), t, y)
    with pytest.raises(ValueError):  # label out of range
        distill_loss_batched(z, t, torch.full_like(y, 16))
    with pytest.raises(ValueError):  # mixed devices
        distill_loss_batched(z, t.cpu(), y)


def test_fedeec_runs_through_the_kernels(cuda):
    from repro_torch.fl.engine import run_experiment

    cfg = FLConfig(num_clients=4, num_edges=2, samples_per_client=16,
                   test_samples=64, image_size=8, embed_dim=16)
    ops.reset_launches()
    res = run_experiment("fedeec", cfg, rounds=1)
    assert np.isfinite(res.acc_curve).all()
    assert all(n > 0 for n in ops.launches.values())
