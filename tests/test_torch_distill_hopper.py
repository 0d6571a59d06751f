"""distill_loss's cross-entropy entry and its kernels' variant rules on the
CPU: the port's CE path (``ops.fused_softmax_xent`` and the CE Function's
plain version) against the JAX package's ``repro.kernels.ops.fused_softmax_xent``
with the Pallas kernel in interpret mode, the rules that pick each CUDA
kernel from integers, the launch arguments each entry is given, and the
absence of any teacher tensor on the CE path.

Tolerances: the loss in fp32 within 1e-6 relative (both sides sum in fp32
in other orders); dz in fp32 within 1e-6 absolute (the fp32 rounding of
p - onehot); bf16 dz within one bf16 ulp of |want| (both sides round nearly
the same fp32 value once: ``ref.distill_loss_grad_bf16_bound`` at beta = 0).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import ops as jax_ops
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import distill_loss as DL
from repro_torch.kernels import ref as R

CSRC = Path(DL.__file__).resolve().parent.parent / "csrc" / "distill_loss.cu"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a test worker, as the other port tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _inputs(N, V, seed=0, last=False):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((N, V)) * 2.0).astype(np.float32)
    y = (np.full(N, V - 1) if last else rng.integers(0, V, N)).astype(np.int32)
    g = rng.standard_normal(N).astype(np.float32)
    return z, y, g


def _bf16(a):
    b = a.astype(ml_dtypes.bfloat16)
    return b, torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)


# (N, V, label at V - 1): a one-class vocabulary, vocabularies no multiple
# of 4 or 8, FedEEC's width, and the last class as every label
CE_CASES = [(5, 1, True), (7, 13, False), (7, 13, True), (8, 10, False), (6, 1003, True),
            (4, 2051, False)]


@pytest.mark.parametrize("N,V,last", CE_CASES)
def test_fused_softmax_xent_fp32_matches_pallas(N, V, last):
    z, y, g = _inputs(N, V, last=last)
    want, vjp = jax.vjp(lambda a: jax_ops.fused_softmax_xent(a, jnp.asarray(y)),
                        jnp.asarray(z))
    (want_dz,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_(True)
    loss = ops.fused_softmax_xent(zt, torch.from_numpy(y).long())
    (dz,) = torch.autograd.grad(loss, zt, torch.from_numpy(g))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dz.numpy(), np.asarray(want_dz), rtol=0, atol=1e-6)


@pytest.mark.parametrize("N,V,last", CE_CASES)
def test_fused_softmax_xent_bf16_matches_pallas(N, V, last):
    z, y, g = _inputs(N, V, seed=1, last=last)
    zj, zt = _bf16(z)
    want, vjp = jax.vjp(lambda a: jax_ops.fused_softmax_xent(a, jnp.asarray(y)),
                        jnp.asarray(zj))
    (want_dz,) = vjp(jnp.asarray(g))
    zt.requires_grad_(True)
    loss = ops.fused_softmax_xent(zt, torch.from_numpy(y).long())
    (dz,) = torch.autograd.grad(loss, zt, torch.from_numpy(g))
    assert loss.dtype == torch.float32 and dz.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    w = torch.from_numpy(np.asarray(want_dz).astype(np.float32))
    bound = R.distill_loss_grad_bf16_bound(w, zt, torch.zeros_like(zt), 0.0,
                                           g=torch.from_numpy(g))
    assert ((dz.float() - w).abs() <= bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lw", [1.0, 0.5])
def test_ce_plain_versions_are_the_t_entry_on_a_zero_t(dtype, lw):
    """The CE Function's plain forward and backward give the bits of the t
    entry's plain versions on an all-zero teacher at beta = 0 (as the CE
    kernel gives the t kernel's: one template)."""
    z, y, g = _inputs(9, 37, seed=2)
    zt = torch.from_numpy(z).to(dtype)
    yt, gt = torch.from_numpy(y), torch.from_numpy(g)
    zero = torch.zeros_like(zt)
    assert torch.equal(R.softmax_xent_ref(zt, yt, lw),
                       R.distill_loss_ref(zt, yt, zero, 0.0, lw))
    assert torch.equal(R.softmax_xent_grad_ref(zt, yt, lw, g=gt),
                       R.distill_loss_grad_ref(zt, yt, zero, 0.0, lw, g=gt))
    zk = zt.clone().requires_grad_(True)
    loss = DL.softmax_xent_batched(zk[None], yt[None], lw)[0]
    (dz,) = torch.autograd.grad(loss, zk, gt)
    assert torch.equal(loss, R.softmax_xent_ref(zt, yt, lw))
    assert torch.equal(dz, R.softmax_xent_grad_ref(zt, yt, lw, g=gt))


class _Factories(TorchDispatchMode):
    """Records the shape of every tensor a factory op makes."""

    FACTORIES = ("zeros", "ones", "full", "empty", "new_zeros", "new_full", "new_empty",
                 "zeros_like", "ones_like", "full_like", "empty_like", "fill", "scalar_tensor")

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] in self.FACTORIES and isinstance(out, torch.Tensor):
            self.made.append((func.__name__, tuple(out.shape)))
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_softmax_xent_allocates_no_teacher(dtype, monkeypatch):
    """No (N, V) tensor is made by a factory op, forward or backward, and
    the t entry's Function is never reached."""
    def refuse(*a, **k):
        raise AssertionError("fused_softmax_xent went through the t entry")

    monkeypatch.setattr(DL.DistillLoss, "apply", refuse)
    z, y, g = _inputs(6, 40, seed=3)
    zt = torch.from_numpy(z).to(dtype).requires_grad_(True)
    with _Factories() as spy:
        loss = ops.fused_softmax_xent(zt, torch.from_numpy(y).long())
        loss.backward(torch.from_numpy(g))
    assert zt.grad is not None
    assert not [m for m in spy.made if m[1] == tuple(zt.shape)], spy.made
    # the spy sees the factory ops: the t entry's caller made a zero teacher
    with _Factories() as spy:
        torch.zeros_like(zt)
    assert spy.made == [("zeros_like.default", tuple(zt.shape))]


# --- the variant rules -------------------------------------------------------


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("rows,V,dtype,want", [
    (8, 10, F32, ("regs", 32)),
    (8, 512, F32, ("regs", 32)),  # 2 KB: 32 threads at 64 bytes
    (8, 513, F32, ("regs", 64)),
    (1024, 2048, F32, ("regs", 128)),
    (66, 4095, F32, ("regs", 256)),
    (66, 4096, F32, ("regs", 256)),  # 16 KB: the register layout's last row
    (66, 4097, F32, ("stream", 512)),
    (1024, 4097, F32, ("stream", 256)),
    (263, 128256, F32, ("stream", 512)),  # fewer than two rows an SM
    (264, 128256, F32, ("stream", 256)),
    (8, 1024, BF16, ("regs", 32)),
    (1024, 2048, BF16, ("regs", 64)),
    (34, 8192, BF16, ("regs", 256)),
    (34, 8193, BF16, ("stream", 512)),
    (1024, 128256, BF16, ("stream", 256)),  # the LM training loss
])
def test_fwd_variant(rows, V, dtype, want):
    assert DL._fwd_variant(rows, V, dtype) == want


@pytest.mark.parametrize("V,dtype,want", [
    (10, F32, ("rows", 32, 1)),
    (2048, F32, ("rows", 128, 1)),
    (4096, F32, ("rows", 256, 1)),
    (4097, F32, ("slices", 256, 2)),
    (128256, F32, ("slices", 256, 32)),
    (8192, BF16, ("rows", 256, 1)),
    (8193, BF16, ("slices", 256, 2)),
    (128256, BF16, ("slices", 256, 16)),
])
def test_bwd_variant(V, dtype, want):
    assert DL._bwd_variant(V, dtype) == want


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_variants_hold_their_rows(dtype):
    """What the C entries check before they launch: a register-layout row
    fits its threads at 64 bytes each (the fp32 scalar path holds 16
    elements a thread, bf16's 32: the same bytes); a backward row fits its
    slices of 256 threads at 64 bytes each."""
    it = dtype.itemsize
    for V in list(range(1, 600)) + list(range(4000, 4200)) + list(range(8100, 8300)) + [128256]:
        name, threads = DL._fwd_variant(100, V, dtype)
        assert name == ("regs" if V * it <= DL.REG_BYTES else "stream")
        if name == "regs":
            assert threads in (32, 64, 128, 256) and V * it <= threads * DL.THREAD_BYTES
            assert threads == 32 or V * it > threads // 2 * DL.THREAD_BYTES  # the fewest
        name, tpr, slices = DL._bwd_variant(V, dtype)
        assert V * it <= slices * tpr * DL.THREAD_BYTES
        assert slices == 1 or (tpr == 256 and V * it > (slices - 1) * DL.REG_BYTES)


# --- the launches each entry makes ---------------------------------------------


def _c_params(name):
    """The parameter names of C entry ``name`` in csrc/distill_loss.cu."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", CSRC.read_text())
    assert m, name
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


@pytest.mark.parametrize("sfx", ["", "_bf16"])
def test_ce_entries_take_no_teacher(sfx):
    for d in ("fwd", "bwd"):
        t_entry, ce = _c_params(f"distill_loss_{d}{sfx}"), _c_params(f"distill_loss_{d}_ce{sfx}")
        assert "t" in t_entry and "beta" in t_entry
        assert "t" not in ce and "beta" not in ce
        assert [p for p in t_entry if p not in ("t", "beta")] == ce
        assert len(_lib._SIGNATURES[f"distill_loss_{d}_ce{sfx}"]) == len(ce)
        assert len(_lib._SIGNATURES[f"distill_loss_{d}{sfx}"]) == len(t_entry)


@pytest.mark.parametrize("dtype,V", [(F32, 10), (F32, 5000), (BF16, 2048), (BF16, 9000)])
@pytest.mark.parametrize("ce", [True, False])
def test_launch_arguments(monkeypatch, dtype, V, ce):
    """``_fwd_cuda`` / ``_bwd_cuda`` with a stand-in launcher: each entry
    gets as many arguments as its C signature has (the stream added by the
    launcher), the CE entries no teacher, the variant the rule picks, and
    every launch counts as distill_loss_fwd / _bwd and once per entry and
    variant."""
    calls = []

    def launch(name, device, *args, count_as=None, flops=None, scratch=()):
        assert len(args) + 1 == len(_lib._SIGNATURES[name]), name
        calls.append((name, args, flops()))
        _lib.launches[count_as or name] += 1

    monkeypatch.setattr(_lib, "launch", launch)
    monkeypatch.setattr(_lib, "check_cuda", lambda *a: None)
    ops.reset_launches()
    z = torch.zeros((2, 3, V), dtype=dtype)
    t = None if ce else torch.zeros_like(z)
    y32 = torch.zeros((2, 3), dtype=torch.int32)
    _, stats = DL._fwd_cuda(z, t, y32, 0.0, 1.0)
    DL._bwd_cuda(z, t, y32, stats, torch.ones((2, 3)), 0.0, 1.0)
    sfx = "_bf16" if dtype == BF16 else ""
    entry = "_ce" if ce else ""
    assert [c[0] for c in calls] == [f"distill_loss_fwd{entry}{sfx}",
                                     f"distill_loss_bwd{entry}{sfx}"]
    fv, threads = DL._fwd_variant(6, V, dtype)
    bv, tpr, slices = DL._bwd_variant(V, dtype)
    assert calls[0][1][-2:] == (DL._LAYOUT[fv], threads)
    assert calls[1][1][-2:] == (tpr, slices)
    assert [c[2] for c in calls] == [DL.loss_flops(d, not ce, 6, V) for d in ("fwd", "bwd")]
    assert ops.launches["distill_loss_fwd"] == ops.launches["distill_loss_bwd"] == 1
    counted = {k: n for k, n in DL.variant_launches.items() if n}
    assert counted == {f"fwd{entry}:{fv}": 1, f"bwd{entry}:{bv}": 1}
    ops.reset_launches()
    assert not any(DL.variant_launches.values())


def test_ce_entry_refuses_a_beta():
    z = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="beta = 0"):
        DL._fwd_cuda(z, None, torch.zeros((1, 2), dtype=torch.int32), 1.5, 1.0)
