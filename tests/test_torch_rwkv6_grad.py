"""The RWKV6 scan's gradient and the chunked time mix in the port against
the JAX package, on the CPU.

``ref.rwkv6_scan_grad_ref`` (the equations the backward kernel
``csrc/rwkv6_scan_bwd.cu`` computes) against ``jax.vjp`` of the reference's
``rwkv6_scan_ref`` and against torch autograd of the port's plain scan, and
``ref.rwkv6_scan_grad_chunked_ref`` (the kernel's chunked matrix form,
phase by phase, at the kernel's chunk and sub-chunk lengths) against both,
extreme decays, w = 0 at the edges of chunks and sub-chunks, and zero or
non-zero final-state cotangents included; ``ops.rwkv6_scan`` under
autograd goes through ``Rwkv6Scan``. ``rwkv6_time_mix_chunked`` against the reference's (y, state
and gradients), and its overflow on extreme decays, shared with the
reference (ROADMAP C12). Inputs come from numpy with a seed; each tolerance
is stated where it is used. The model-level tests are in
``tests/test_torch_rwkv6_train.py``."""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.kernels.ref import rwkv6_scan_ref as jax_scan_ref
from repro.models import ModelOpts as JaxOpts
from repro.models import init_params as jax_init_params
from repro.models.ssm import rwkv6_time_mix_chunked as jax_time_mix_chunked
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import rwkv6_scan as RS
from repro_torch.kernels.rwkv6_scan import Rwkv6Scan
from repro_torch.models import ssm as S

ARCH = "rwkv6-1.6b"
B = 2



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a worker, as ``tests/test_torch_isolation.py``:
    the suite's workers share the cores, and one thread per core each
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

# --- the scan's gradient ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scan_case(T, hd, extreme, zero_dsT, Bs=2, H=2, zero_at=()):
    """r, k, v, w, u, s0 and the cotangents dy, dsT, as numpy fp32; w = 0
    exactly at the steps ``zero_at``."""
    rng = np.random.default_rng(T * 131 + hd)
    shp = (Bs, T, H, hd)
    r, k, v = ((rng.standard_normal(shp) * 0.3).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal(shp)))).astype(np.float32)
    if extreme:
        w[:, ::7] = 1e-30  # every 7th step forgets the state
        w[:, 3::5, :, ::2] = 1.0  # half the rows of every 5th step keep it whole
    w[:, [t for t in zero_at if t < T]] = 0.0
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((Bs, H, hd, hd)) * 0.1).astype(np.float32)
    dy = rng.standard_normal(shp).astype(np.float32)
    dsT = rng.standard_normal((Bs, H, hd, hd)).astype(np.float32) * (not zero_dsT)
    return r, k, v, w, u, s0, dy, dsT


def _jax_vjp(case):
    *ins, dy, dsT = case
    _, vjp = jax.vjp(jax_scan_ref, *(jnp.asarray(a) for a in ins))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dsT)))]


def _close_to(got, want, share):
    """Every gradient within ``share`` of that input's max |g|."""
    for g, wnt in zip(got, want):
        g, wnt = np.asarray(g), np.asarray(wnt)
        assert g.shape == wnt.shape and np.isfinite(g).all()
        assert np.abs(g - wnt).max() <= share * np.abs(wnt).max()


# (T, hd, extreme, zero dsT): every T at both head dims; extreme decays and
# a zero dsT each at half the cases
GRAD_CASES = [(T, hd, (T + hd // 16) % 2 == 1, T % 3 == 1)
              for T in (1, 5, 16, 17, 64, 100) for hd in (16, 32)]
# (chunk, sub-chunk) lengths of the chunked form: the kernel's at head_dim
# up to 64 and at 128 (kernels/rwkv6_scan.py:_bwd_chunk, with its fixed
# sub-chunk BWD_SUB), and short ragged ones (several sub-chunks a chunk,
# many chunks)
GRAD_LENGTHS = [(RS._bwd_chunk(64), RS.BWD_SUB), (RS._bwd_chunk(128), RS.BWD_SUB), (10, 5)]


@pytest.mark.parametrize("T,hd,extreme,zero_dsT", GRAD_CASES)
def test_grad_ref_matches_jax_vjp_and_autograd(T, hd, extreme, zero_dsT):
    """The plain backward against ``jax.vjp`` of the reference's scan and
    torch autograd of the port's plain scan, every gradient within 1e-5 of
    that input's max |g| (fp32 sums over hd and T in other orders); the
    kernel's chunked matrix form at each (chunk, sub-chunk) of
    ``GRAD_LENGTHS`` (ragged last chunks and sub-chunks, one chunk, many)
    within the same bound. A decay of 1e-30 or 1 gives finite, exact
    gradients: nothing divides by w."""
    case = _scan_case(T, hd, extreme, zero_dsT)
    t = [torch.from_numpy(a) for a in case]
    got = R.rwkv6_scan_grad_ref(*t)
    want = _jax_vjp(case)
    _close_to([g.numpy() for g in got], want, 1e-5)
    ins = [a.clone().requires_grad_(True) for a in t[:6]]
    y, sT = R.rwkv6_scan_ref(*ins)
    auto = torch.autograd.grad((y, sT), ins, (t[6], t[7]))
    _close_to([g.numpy() for g in got], [g.numpy() for g in auto], 1e-5)
    for chunk, sub in GRAD_LENGTHS:
        chunked = R.rwkv6_scan_grad_chunked_ref(*t, chunk, sub)
        _close_to([g.numpy() for g in chunked], want, 1e-5)


# T around the kernel's sub-chunk (16) and chunk (64): below a sub-chunk,
# one short, exact, one over, and the same at the chunk; each at both head
# dims, a zero dsT at half of them
EDGE_TS = (7, 15, 16, 17, 63, 64, 65)
EDGE_ZEROS = (0, 15, 16, 31, 32, 47, 48, 63, 64)  # every sub-chunk's and chunk's edges


@pytest.mark.parametrize("T,hd", [(T, hd) for T in EDGE_TS for hd in (16, 32)])
def test_grad_chunked_at_block_edges_matches_jax_vjp(T, hd):
    """The chunked matrix form at the kernel's lengths (chunks of 64,
    sub-chunks of 16) and at chunks of 32, against ``jax.vjp``, each
    gradient within 1e-5 of its max |g|, with w = 0 exactly at the first
    and last step of every sub-chunk and chunk (a wiped state at each edge
    of the blocks: a form that divided by a decay product would give nan
    there), T just below, at and above a sub-chunk and a chunk, and dsT
    zero or not."""
    zero_dsT = (T + hd // 16) % 2 == 0
    case = _scan_case(T, hd, False, zero_dsT, zero_at=EDGE_ZEROS)
    t = [torch.from_numpy(a) for a in case]
    want = _jax_vjp(case)
    assert (t[3] == 0).any() and (np.abs(want[3]) > 0).any()
    for chunk, sub in ((RS.BWD_CHUNK, RS.BWD_SUB), (32, RS.BWD_SUB)):
        got = R.rwkv6_scan_grad_chunked_ref(*t, chunk, sub)
        _close_to([g.numpy() for g in got], want, 1e-5)


def test_grad_chunked_needs_sub_chunks_that_divide_the_chunk():
    t = [torch.from_numpy(a) for a in _scan_case(5, 16, False, False)]
    with pytest.raises(ValueError, match="divide"):
        R.rwkv6_scan_grad_chunked_ref(*t, 16, 6)


def test_bwd_entries_match_their_source():
    """The backward's C entries take as many arguments as ``_lib`` passes
    them (the launch entry the stream last, the shared-memory query none),
    the sub-chunk length the tests and bounds use is the kernel's
    compile-time one, and the chunk ``_bwd_chunk`` picks at each head dim
    is one the entry takes (a multiple of the sub-chunk up to 128, the
    sub-chunk itself at head_dim 128)."""
    src = (Path(RS.__file__).parents[1] / "csrc" / "rwkv6_scan_bwd.cu").read_text()
    for name, stream in (("rwkv6_scan_bwd", True), ("rwkv6_scan_bwd_smem", False)):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
        assert len(params) == len(_lib._SIGNATURES[name]), name
        assert (params[-1] == "stream") == stream, name
    assert re.search(r"constexpr int kSubChunk = (\d+);", src).group(1) == str(RS.BWD_SUB)
    max_chunk = int(re.search(r"constexpr int kMaxChunk = (\d+);", src).group(1))
    for hd in RS.HEAD_DIMS:
        chunk = RS._bwd_chunk(hd)
        assert chunk % RS.BWD_SUB == 0 and chunk <= max_chunk
        assert hd != 128 or chunk == RS.BWD_SUB


def test_extreme_decays_give_the_exact_dw():
    """Where w_t = 0 the state is wiped and dw_t[i] = Σ_j G_t[i,j]
    S_{t-1}[i,j] is still well defined; the plain backward matches autograd
    there bit for bit in the wiped rows' structure (both finite), and a form
    that divides w ⊙ dw by w would give nan at w = 0."""
    r, k, v, w, u, s0, dy, dsT = (torch.from_numpy(a).clone()
                                  for a in _scan_case(17, 16, True, False))
    w[:, 4] = 0.0
    got = R.rwkv6_scan_grad_ref(r, k, v, w, u, s0, dy, dsT)
    ins = [a.clone().requires_grad_(True) for a in (r, k, v, w, u, s0)]
    y, sT = R.rwkv6_scan_ref(*ins)
    want = torch.autograd.grad((y, sT), ins, (dy, dsT))
    assert got[3][:, 4].abs().max() > 0  # dw is not 0 where w is
    _close_to([g.numpy() for g in got], [g.numpy() for g in want], 1e-5)


@pytest.mark.parametrize("T", [1, 17])
def test_op_goes_through_the_autograd_function_on_the_cpu(T):
    """On CPU tensors that require grad, ``ops.rwkv6_scan`` records
    ``Rwkv6Scan`` and its backward is the plain backward, bit for bit;
    without grad it records nothing, and y and the state equal the plain
    scan's bit for bit either way."""
    t = [torch.from_numpy(a) for a in _scan_case(T, 16, False, False)]
    ins = [a.clone().requires_grad_(True) for a in t[:6]]
    y, sT = ops.rwkv6_scan(*ins)
    assert type(y.grad_fn).__name__ == "Rwkv6ScanBackward"
    got = torch.autograd.grad((y, sT), ins, (t[6], t[7]))
    want = R.rwkv6_scan_grad_ref(*t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    yr, sr = R.rwkv6_scan_ref(*t[:6])
    assert torch.equal(y.detach(), yr) and torch.equal(sT.detach(), sr)
    with torch.no_grad():
        y0, _ = ops.rwkv6_scan(*ins)
    assert y0.grad_fn is None and torch.equal(y0, yr)
    # only the inputs that require grad get one
    ins = [a.clone().requires_grad_(i == 3) for i, a in enumerate(t[:6])]
    y, sT = Rwkv6Scan.apply(*ins)
    (gw,) = torch.autograd.grad((y, sT), [ins[3]], (t[6], t[7]))
    assert torch.equal(gw, want[3])


# --- the chunked time mix ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init():
    """(jcfg, the reference's reduced rwkv6-1.6b params as numpy)."""
    jcfg = jax_reduced(jax_get_arch(ARCH))
    init = jax.jit(lambda key: jax_init_params(key, jcfg, JaxOpts(remat=False)))
    return jcfg, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _block_params(seed=3, decay=0.0):
    """One reduced rwkv6 block's time-mix params from the JAX init, moved
    off its zeros (u, mu, the LoRAs' second factors) so every term counts;
    ``decay`` is added to w0."""
    jcfg, jp = _jax_init()
    p = {k: a[0].copy() for k, a in jp["unit"]["blk0"]["rwkv"].items()}
    rng = np.random.default_rng(seed)
    for name in ("u", "mu", "mu_base", "lora_B", "decay_B"):
        p[name] = p[name] + (0.1 * rng.standard_normal(p[name].shape)).astype(np.float32)
    p["w0"] = p["w0"] + np.float32(decay)
    return jcfg, reduced(get_arch(ARCH)), p


def _mix_inputs(jcfg, seed=4, S_=32):
    rng = np.random.default_rng(seed)
    d, H, hd = jcfg.d_model, jcfg.ssm_heads, jcfg.ssm_head_dim
    x = rng.standard_normal((B, S_, d)).astype(np.float32)
    st = {"tm_x": rng.standard_normal((B, d)).astype(np.float32),
          "cm_x": np.zeros((B, d), np.float32),
          "s": (0.1 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)}
    ct = rng.standard_normal((B, S_, d)).astype(np.float32)
    cs = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return x, st, ct, cs


def test_time_mix_chunked_matches_the_reference():
    """Chunk 8, S = 32, from a non-zero state: y and the new state, and the
    gradients of <y, ct> + <s, cs> with respect to x, the state and every
    param, each within 1e-5 of its max |value| (fp32 products of cumulative
    log decays and sums in other orders; the state reaches 39 here)."""
    jcfg, cfg, p = _block_params()
    x, st, ct, cs = _mix_inputs(jcfg)

    def jax_fn(p_, x_, s_):
        y, new = jax_time_mix_chunked(jcfg, p_, x_, {**st, "s": s_}, 8)
        return y, new["s"]

    jargs = (jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(st["s"]))
    (wy, ws), vjp = jax.vjp(jax.jit(jax_fn), *jargs)
    wg = jax.jit(vjp)((jnp.asarray(ct), jnp.asarray(cs)))

    tp = {k: torch.from_numpy(a).requires_grad_(True) for k, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(st["s"]).requires_grad_(True)
    tstate = {"tm_x": torch.from_numpy(st["tm_x"]), "cm_x": torch.from_numpy(st["cm_x"]),
              "s": ts}
    y, new = S.rwkv6_time_mix_chunked(cfg, tp, tx, tstate, 8)
    _close_to([y.detach().numpy(), new["s"].detach().numpy()], [wy, ws], 1e-5)
    assert torch.equal(new["tm_x"], tx.detach()[:, -1])
    names = sorted(p)
    got = torch.autograd.grad((y, new["s"]), [tp[n] for n in names] + [tx, ts],
                              (torch.from_numpy(ct), torch.from_numpy(cs)),
                              allow_unused=True)
    want = [wg[0][n] for n in names] + [wg[1], wg[2]]
    for name, g, wnt in zip(names + ["x", "s"], got, want):
        wnt = np.asarray(wnt)
        g = np.zeros_like(wnt) if g is None else g.numpy()
        assert np.abs(g - wnt).max() <= 1e-5 * max(np.abs(wnt).max(), 1e-30), name


def test_time_mix_chunked_overflows_on_extreme_decay_as_the_reference():
    """ROADMAP C12, shared with the reference: the chunked form multiplies k
    by exp(-cum), the inverse of a chunk's cumulative decay, which leaves
    fp32's range once a chunk's decays multiply below about 1e-38 (here w0
    + 10 gives w = exp(-exp(4)) ≈ 2e-24 a step). Both packages then give
    non-finite outputs at the same places; the exact scan (``ops.rwkv6_scan``,
    the kernels on the card) stays finite. The port keeps the reference's
    arithmetic."""
    jcfg, cfg, p = _block_params(decay=10.0)
    x, st, _, _ = _mix_inputs(jcfg)
    wy, _ = jax.jit(lambda *a: jax_time_mix_chunked(jcfg, *a, 8))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    tst = {k: torch.from_numpy(a) for k, a in st.items()}
    y, _ = S.rwkv6_time_mix_chunked(cfg, tp, torch.from_numpy(x), tst, 8)
    wy = np.asarray(wy)
    assert not np.isfinite(wy).all()
    assert np.array_equal(np.isfinite(y.numpy()), np.isfinite(wy))
    y_scan, _ = S.rwkv6_time_mix(cfg, tp, torch.from_numpy(x), tst)
    assert torch.isfinite(y_scan).all()
