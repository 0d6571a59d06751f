"""MLA (deepseek-v2-lite-16b's multi-head latent attention) in the port
against the JAX package, on the CPU: ``mla_forward``'s expanded prefill and
absorbed decode from the reference's parameters (``lm_from_jax``) and the
same numpy inputs, fp32 and bf16, decode past the cache's end included;
``flash_attention_ref`` with v narrower than q and k against the
reference's ``mha``; the latent decode's plain version, and a plain-torch
emulation of its kernel's split-and-merge arithmetic, against the
reference's absorbed einsums; the compressed cache's two leaves as views of
one buffer; and the wrappers' CUDA paths as far as the CPU reaches them
(the launch arguments, the instances that raise, the C entries' ctypes
signatures). On the card the kernels are held to their plain versions
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import ctypes
import math
import re
from dataclasses import replace
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import attention as JA
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as R
from repro_torch.models import attention as A
from repro_torch.models.transformer import ModelOpts, init_cache

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5  # fp32 sums in other orders through one attention layer
BF16_ULP = 2.0**-7  # one bf16 ulp of x is at most 2^-7 |x|
LOG2E = 1.0 / math.log(2.0)
CSRC = Path(FA.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mla(request):
    """(jcfg, cfg, jax params, port params, dtype) of one reduced MLA layer
    (q and k 48 wide, v 32, latent 32 + rope 16, 4 heads)."""
    dt = request.param
    jcfg = replace(jax_reduced(jax_get_arch(ARCH)), param_dtype=dt)
    cfg = replace(reduced(get_arch(ARCH)), param_dtype=dt)
    jp = jax.tree.map(np.asarray, JA.init_mla(jax.random.PRNGKey(7), jcfg, jnp.dtype(dt)))
    return jcfg, cfg, jp, lm_from_jax(jp), dt


def _x(cfg, B, S, dt, seed):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(dt), torch.from_numpy(x).to(getattr(torch, dt))


def _close(got, want, dt):
    """fp32: within TOL. bf16: within one bf16 ulp of the largest |want|
    (both packages compute each product in fp32 and round once to bf16;
    where an fp32 result lies at a rounding boundary the two round to
    adjacent bf16 numbers)."""
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    tol = TOL if dt == "float32" else BF16_ULP * np.abs(w).max()
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_prefill_matches_the_reference(mla):
    """The expanded form: y and the latent entries (c_kv, k_rope) it
    returns to seed a cache."""
    jcfg, cfg, jp, p, dt = mla
    jx, x = _x(cfg, 2, 11, dt, 0)
    pos = np.arange(11)
    want, want_kv = JA.mla_forward(jcfg, jax.tree.map(jnp.asarray, jp), jx,
                                   positions=jnp.asarray(pos), theta=cfg.rope_theta,
                                   return_kv=True)
    got, kv = A.mla_forward(cfg, p, x, positions=torch.from_numpy(pos),
                            theta=cfg.rope_theta, return_kv=True)
    assert got.dtype == x.dtype
    _close(got, want, dt)
    _close(kv["c_kv"], want_kv["c_kv"], dt)
    _close(kv["k_rope"], want_kv["k_rope"], dt)


@pytest.mark.parametrize("chunk", [0, 8])
def test_training_form_matches_prefill(chunk):
    """``train=True`` runs the same expanded form through ``mha`` (with a
    chunk): the prefill's y, within TOL in fp32."""
    cfg = reduced(get_arch(ARCH))
    p = lm_from_jax(jax.tree.map(np.asarray, JA.init_mla(
        jax.random.PRNGKey(5), jax_reduced(jax_get_arch(ARCH)), jnp.float32)))
    _, x = _x(cfg, 2, 16, "float32", 1)
    pos = torch.arange(16)
    want, _ = A.mla_forward(cfg, p, x, positions=pos, theta=cfg.rope_theta)
    got, _ = A.mla_forward(cfg, p, x, positions=pos, theta=cfg.rope_theta, chunk=chunk,
                           train=True)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("pos", [0, 5, 15, 17])
def test_absorbed_decode_matches_the_reference(mla, pos):
    """One decode step against a 16-long cache of random latent entries in
    the model's dtype, at positions inside the cache, at its last slot and
    past its end (where the reference's dynamic_update_slice clamps the
    write to the last slot and every slot is attended): y and both cache
    leaves, the port's written in place."""
    jcfg, cfg, jp, p, dt = mla
    rng = np.random.default_rng(pos)
    jx, x = _x(cfg, 2, 1, dt, 10 + pos)
    ckv = rng.standard_normal((2, 16, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((2, 16, cfg.qk_rope_dim)).astype(np.float32)
    jcache = {"c_kv": jnp.asarray(ckv).astype(dt), "k_rope": jnp.asarray(krope).astype(dt)}
    want, want_c = JA.mla_forward(jcfg, jax.tree.map(jnp.asarray, jp), jx,
                                  positions=jnp.asarray([pos]), theta=cfg.rope_theta,
                                  cache=jcache, cache_pos=jnp.asarray(pos))
    cache = A.init_mla_cache(cfg, 2, 16, getattr(torch, dt))
    cache["c_kv"].copy_(torch.from_numpy(ckv))
    cache["k_rope"].copy_(torch.from_numpy(krope))
    got, c2 = A.mla_forward(cfg, p, x, positions=torch.tensor([pos]), theta=cfg.rope_theta,
                            cache=cache, cache_pos=pos)
    assert c2 is cache and got.dtype == x.dtype
    _close(got, want, dt)
    _close(cache["c_kv"], want_c["c_kv"], dt)
    _close(cache["k_rope"], want_c["k_rope"], dt)


def test_decode_with_a_bf16_cache_keeps_q_in_fp32():
    """An fp32 model against a bf16 cache: the reference's q_lat and
    q_rope stay fp32 against the widened cache (C6), so the port's y is
    held to it within TOL."""
    jcfg = jax_reduced(jax_get_arch(ARCH))
    cfg = reduced(get_arch(ARCH))
    jp = jax.tree.map(np.asarray, JA.init_mla(jax.random.PRNGKey(8), jcfg, jnp.float32))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((2, 12, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((2, 12, cfg.qk_rope_dim)).astype(np.float32)
    jcache = {"c_kv": jnp.asarray(ckv, jnp.bfloat16), "k_rope": jnp.asarray(krope, jnp.bfloat16)}
    want, _ = JA.mla_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             positions=jnp.asarray([7]), theta=cfg.rope_theta, cache=jcache,
                             cache_pos=jnp.asarray(7))
    cache = A.init_mla_cache(cfg, 2, 12, torch.bfloat16)
    cache["c_kv"].copy_(torch.from_numpy(ckv))
    cache["k_rope"].copy_(torch.from_numpy(krope))
    got, _ = A.mla_forward(cfg, lm_from_jax(jp), torch.from_numpy(x),
                           positions=torch.tensor([7]), theta=cfg.rope_theta, cache=cache,
                           cache_pos=7)
    _close(got, want, "float32")


# --- flash_attention with v narrower than q and k ------------------------------


@pytest.mark.parametrize("Sq,Sk,q_offset", [(12, 12, 0), (5, 20, 15), (1, 20, 9)])
def test_flash_attention_ref_at_a_narrower_v_matches_mha(Sq, Sk, q_offset):
    """q and k 48 wide, v 32 (the reduced MLA's expanded form; the card's
    instance is 192 / 128): the plain version, and the wrapper on CPU
    tensors, against the reference's ``mha`` (scale 48^-0.5, q's head_dim)."""
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((2, Sq, 4, 48)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 4, 48)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 4, 32)).astype(np.float32)
    want = JA.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  q_positions=jnp.arange(Sq) + q_offset, k_positions=jnp.arange(Sk), causal=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = R.flash_attention_ref(tq, tk, tv, causal=True, q_offset=q_offset)
    assert got.shape == (2, Sq, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    ops.reset_launches()
    assert torch.equal(ops.flash_attention(tq, tk, tv, q_offset=q_offset), got)
    assert ops.launches["flash_attention"] == 0


def test_flash_attention_checks_the_narrower_v():
    q = torch.zeros((1, 4, 2, 48))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 4, 2, 48)), torch.zeros((1, 5, 2, 32)))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 4, 2, 32)), torch.zeros((1, 4, 2, 32)))


# --- the latent decode: plain version and the kernel's arithmetic --------------


def _jax_absorbed(q, ckv, krope, scale, q_offset):
    """The reference's absorbed decode after q_lat (``mla_forward``'s
    einsums), q (B, 1, N, L + R) fp32."""
    L = ckv.shape[-1]
    q = jnp.asarray(q, jnp.float32)
    ckv = jnp.asarray(ckv).astype(jnp.float32)
    s_nope = jnp.einsum("bqnl,bsl->bnqs", q[..., :L], ckv)
    s_rope = jnp.einsum("bqnd,bsd->bnqs", q[..., L:], jnp.asarray(krope).astype(jnp.float32))
    s = (s_nope + s_rope) * scale
    valid = jnp.arange(ckv.shape[1])[None, :] <= q_offset
    s = jnp.where(valid[None, None], s, JA.NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    return np.asarray(jnp.einsum("bnqs,bsl->bqnl", p, ckv))


def _latent_inputs(B, S, N, L, Rd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, 1, N, L + Rd)) * 0.5).astype(np.float32)
    kv = (rng.standard_normal((B, S, L + Rd)) * 0.5).astype(np.float32)
    buf = torch.from_numpy(kv).to(dtype)
    return torch.from_numpy(q), buf[..., :L], buf[..., L:]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero, as the kernel's ``tf32_rna`` (``cvt.rna.tf32.f32``) rounds:
    add half of the dropped 13 bits' range to the bit pattern and clear
    them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _bf16_parts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x as three bf16 parts, each rounded to nearest even, largest first,
    as the kernel's ``split3``: x1 + x2 + x3 is x within 2^-24 |x|."""
    x1 = x.bfloat16().float()
    x2 = (x - x1).bfloat16().float()
    return x1, x2, (x - x1 - x2).bfloat16().float()


def _emulate_latent(q, ckv, krope, scale, q_offset, q_residual=True):
    """The kernel's arithmetic on its plan (``FA._latent_plan``), per split
    in steps from the split's start, rows past the split zero. A bf16 cache
    (the wgmma kernel): steps of 64 keys; q and p as three bf16 parts; S as
    two warpgroups' partials over D / 2-column halves, each (q3 K + q2 K) +
    q1 K (K exact); ctx as three accumulators, acc_k = acc_k alpha + p_k V,
    summed (acc_3 + acc_2) + acc_1 at the split's end. An fp32 cache (the
    mma.sync kernel): steps of 32 keys; q and p split into TF32 hi + lo; S
    as 8 warps' partials over D / 8 columns, each q_lo K_hi + q_hi K_lo +
    q_hi K_hi; ctx = ctx alpha + p V with p split as q. Both: the partials
    added in order, scaled; keys past the split -1e30; an online softmax in
    the log2 domain; then, in split order, m* = max m_s, l = sum l_s 2^(m_s
    - m*), ctx = sum acc_s 2^(m_s - m*) / max(l, 1e-30). The plan's
    value-column groups repeat the same arithmetic on their columns, so
    they change nothing here. ``q_residual=False`` keeps q's first part alone: q
    rounded once, to bf16 (C6) or to TF32."""
    B, _, N, D = q.shape
    S, L = ckv.shape[1], ckv.shape[2]
    kv = torch.cat([ckv, krope], -1).float()
    if ckv.dtype == torch.bfloat16:
        step, slices, parts = FA.LATENT_TILE, 2, _bf16_parts

        def terms(xs, b, eq):
            return [torch.einsum(eq, x, b) for x in reversed(xs)]
    else:
        step, slices, parts = 32, 8, _split

        def terms(xs, b, eq):
            (ah, al), (bh, bl) = xs, _split(b)
            out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            return [out + torch.einsum(eq, ah, bh)]

    def add(ts):  # in order, left to right
        return sum(ts[1:], ts[0])

    qs = parts(q[:, 0].float())
    if not q_residual:
        qs = (qs[0],) + tuple(torch.zeros_like(x) for x in qs[1:])
    chunk, splits, _ = FA._latent_plan(B, S, q_offset)
    width = D // slices
    j_hi = min(q_offset, S - 1)
    out_parts = []
    for s in range(splits):
        s0, s1 = s * chunk, min(s * chunk + chunk - 1, j_hi)
        m = torch.full((B, N), -1e30)
        l = torch.zeros((B, N))
        accs = None
        for base in range(s0, s1 + 1, step):
            keys = torch.arange(base, base + step)
            rows = kv[:, keys.clamp(max=S - 1)] * (keys <= s1)[None, :, None]
            sc = torch.zeros((B, N, step))
            for w in range(slices):
                c = slice(w * width, (w + 1) * width)
                sc = sc + add(terms(tuple(x[..., c] for x in qs), rows[..., c], "bnd,bjd->bnj"))
            sc = torch.where(keys <= s1, sc * scale, -1e30)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp2((sc - m_new[..., None]) * LOG2E)
            alpha = torch.exp2((m - m_new) * LOG2E)
            l = l * alpha + p.sum(-1)
            pv = terms(parts(p), rows[..., :L], "bnj,bjl->bnl")
            accs = pv if accs is None else [a * alpha[..., None] + t for a, t in zip(accs, pv)]
            m = m_new
        out_parts.append((m, l, add(accs)))
    m_star = torch.stack([m for m, _, _ in out_parts]).amax(0)
    lsum, out = torch.zeros((B, N)), torch.zeros((B, N, L))
    for m, l, acc in out_parts:
        f = torch.exp2((m - m_star) * LOG2E)
        lsum = lsum + l * f
        out = out + acc * f[..., None]
    return (out / lsum.clamp_min(1e-30)[..., None])[:, None]


LATENT_CASES = [  # (B, S, N, q_offset); at B = 8 serving's q_offset 0, a
    # range that ends inside a step, and 127 (splits of 64 keys, the value
    # columns across blocks)
    (2, 40, 4, 0), (2, 40, 4, 33), (2, 40, 4, 39), (2, 40, 4, 57),
    (1, 700, 16, 650), (3, 300, 16, 299),
    (8, 130, 16, 0), (8, 130, 16, 50), (8, 130, 16, 127),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,N,q_offset", LATENT_CASES)
def test_latent_decode_ref_matches_the_reference_einsums(B, S, N, q_offset, dtype):
    """The plain version and the kernel's emulation at the reduced dims (32
    + 16) and at deepseek-v2-lite-16b's (512 + 64), scale 192^-0.5 (the
    reference's (nope + rope)^-0.5, not the row's 576^-0.5), a bf16 or fp32
    cache, q_offset inside, at the end of and past the cache."""
    L, Rd = (32, 16) if S < 100 else (512, 64)
    q, ckv, krope = _latent_inputs(B, S, N, L, Rd, dtype, seed=S + q_offset)
    scale = 192**-0.5
    want = _jax_absorbed(q.numpy(), ckv.float().numpy(), krope.float().numpy(), scale,
                         q_offset)
    got = R.latent_decode_ref(q, ckv, krope, scale=scale, q_offset=q_offset)
    assert got.dtype == torch.float32 and got.shape == (B, 1, N, L)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    emulated = _emulate_latent(q, ckv, krope, scale, q_offset)
    np.testing.assert_allclose(emulated.numpy(), want, rtol=0, atol=TOL)


def test_latent_decode_at_the_rows_scale_fails():
    """The check above tells the scales apart: at 576^-0.5 (the key row's
    width, not q and k's head_dim) the plain version misses the reference
    by far more than TOL."""
    q, ckv, krope = _latent_inputs(2, 40, 4, 32, 16, torch.float32, seed=1)
    want = _jax_absorbed(q.numpy(), ckv.numpy(), krope.numpy(), 192**-0.5, 39)
    wrong = R.latent_decode_ref(q, ckv, krope, scale=576**-0.5, q_offset=39)
    assert np.abs(wrong.numpy() - want).max() > 100 * TOL


def test_the_emulation_needs_its_mask_past_the_split():
    """The emulation is not vacuous: without the mask past a split's end
    (zero rows scored 0 instead of -1e30), it misses the reference."""
    q, ckv, krope = _latent_inputs(1, 700, 16, 512, 64, torch.float32, seed=2)
    want = _jax_absorbed(q.numpy(), ckv.numpy(), krope.numpy(), 192**-0.5, 650)
    with mock.patch.object(torch, "where", side_effect=lambda c, a, b: a):
        wrong = _emulate_latent(q, ckv, krope, 192**-0.5, 650)
    assert np.abs(wrong.numpy() - want).max() > 100 * TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_emulation_needs_q_s_residual(dtype):
    """The split is not vacuous (C6's kin): q rounded once, with no residual
    product (to bf16 for the bf16 cache's kernel, which is C6 itself; to
    TF32 for the fp32 cache's), misses the reference einsums by more than
    100 TOL at deepseek-v2-lite-16b's dims, where the split form is within
    TOL. The cache at unit scale (c_kv is RMS-normed) and q at 2."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy((rng.standard_normal((2, 1, 16, 576)) * 2).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 700, 576)).astype(np.float32)).to(dtype)
    ckv, krope = kv[..., :512], kv[..., 512:]
    want = _jax_absorbed(q.numpy(), ckv.float().numpy(), krope.float().numpy(), 192**-0.5, 40)
    split = _emulate_latent(q, ckv, krope, 192**-0.5, 40)
    np.testing.assert_allclose(split.numpy(), want, rtol=0, atol=TOL)
    rounded = _emulate_latent(q, ckv, krope, 192**-0.5, 40, q_residual=False)
    assert np.abs(rounded.numpy() - want).max() > 100 * TOL


def test_tf32_rna_keeps_ten_mantissa_bits():
    """The emulation's rounding: 13 low bits cleared, to nearest with ties
    away from zero, and hi + lo within 2^-22 of x."""
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11), 3.0e-3])
    hi = tf32_rna(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert hi[:3].tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-9, -(1.0 + 2.0**-10)]
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    h, lo = _split(xs)
    assert ((h + lo - xs).abs() <= 2.0**-22 * xs.abs()).all()


def test_bf16_parts_keep_24_bits():
    """The wgmma kernel's split of q and p: three bf16 parts, each exact in
    bf16, whose sum is x within 2^-24 |x|; two parts alone miss that."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4000).astype(np.float32))
    x = torch.cat([x, torch.exp2(-torch.arange(20.0)), torch.tensor([0.0, -3.0e-3])])
    x1, x2, x3 = _bf16_parts(x)
    for part in (x1, x2, x3):
        assert torch.equal(part, part.bfloat16().float())
    assert ((x1 + x2 + x3 - x).abs() <= 2.0**-24 * x.abs()).all()
    assert ((x1 + x2 - x).abs() > 2.0**-20 * x.abs()).any()


# serving's ranges (q_offset 0-127 at B = 8), a mid-tile end, a full cache
# and past it, one sequence, other batches and caches
PLAN_CASES = [(8, 4096, qo) for qo in (0, 1, 30, 31, 32, 50, 63, 64, 100, 127, 255, 1000,
                                        4095, 5000)]
PLAN_CASES += [(1, 4096, 4095), (1, 4096, 10), (2, 300, 100), (3, 1000, 777), (16, 4096, 4095),
               (132, 4096, 4095), (200, 64, 63), (8, 1, 0), (8, 40, 39)]


@pytest.mark.parametrize("B,S,q_offset", PLAN_CASES)
def test_latent_plan_covers_the_range_and_fills_the_card(B, S, q_offset):
    """``_latent_plan``: chunks a multiple of the tile, no split empty, the
    splits cover [0, min(q_offset, S - 1)], at most LATENT_MAX_SPLITS, 1-8
    value-column groups, and a grid within one wave of one block an SM.
    At B = 8 every range that ``serve`` runs (1-128 keys) gets 32 blocks
    at least (more than 8 at 64 and 128 keys), a full cache 128."""
    chunk, splits, vsplits = FA._latent_plan(B, S, q_offset)
    n = min(q_offset, S - 1) + 1
    assert chunk % FA.LATENT_TILE == 0 and chunk > 0
    assert (splits - 1) * chunk < n <= splits * chunk
    assert 1 <= splits <= FA.LATENT_MAX_SPLITS
    assert vsplits in (1, 2, 4)
    blocks = B * splits * vsplits
    assert blocks <= max(FA.SMS, B)
    if B == 8 and n <= 128:
        assert blocks >= 32
    if B == 8 and n in (64, 128):
        assert blocks > 8
    if B == 8 and n == 4096:
        assert (splits, vsplits) == (16, 1) and blocks == 128


# --- the compressed cache ------------------------------------------------------


def test_cache_leaves_alias_one_buffer():
    """``init_mla_cache``'s c_kv and k_rope are views of one (B, S, lora +
    rope) buffer: k_rope's first element sits right after c_kv's row, one
    row apart is one lora + rope stride, and a write through either shows
    in the buffer; ``init_cache`` stacks a unit's repeats in one buffer the
    same way. A decode step writes both in place."""
    cfg = reduced(get_arch(ARCH))
    L, Rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    for dtype in (torch.float32, torch.bfloat16):
        c = A.init_mla_cache(cfg, 2, 6, dtype)
        ckv, kr = c["c_kv"], c["k_rope"]
        assert ckv.shape == (2, 6, L) and kr.shape == (2, 6, Rd)
        assert ckv.untyped_storage().data_ptr() == kr.untyped_storage().data_ptr()
        assert kr.data_ptr() - ckv.data_ptr() == L * ckv.element_size()
        assert ckv.stride() == kr.stride() == (6 * (L + Rd), L + Rd, 1)
        buf = torch.as_strided(ckv, (2, 6, L + Rd), ckv.stride())
        kr[1, 3].fill_(2.0)
        ckv[0, 5].fill_(-1.0)
        assert (buf[1, 3, L:] == 2).all() and (buf[0, 5, :L] == -1).all()
        assert buf.sum().item() == 2.0 * Rd - L
    full = replace(reduced(get_arch(ARCH)), n_repeats=3, num_layers=4)
    states = init_cache(full, ModelOpts(), 2, 5, torch.bfloat16, device="cpu")
    unit = states["unit"]["blk0"]
    assert unit["c_kv"].shape == (3, 2, 5, L) and unit["k_rope"].shape == (3, 2, 5, Rd)
    assert unit["k_rope"].data_ptr() - unit["c_kv"].data_ptr() == 2 * L
    for r in range(3):
        assert unit["k_rope"][r].data_ptr() - unit["c_kv"][r].data_ptr() == 2 * L
    head = states["head"][0]
    assert head["k_rope"].data_ptr() - head["c_kv"].data_ptr() == 2 * L


def test_decode_writes_the_cache_in_place():
    cfg = reduced(get_arch(ARCH))
    p = lm_from_jax(jax.tree.map(np.asarray, JA.init_mla(
        jax.random.PRNGKey(1), jax_reduced(jax_get_arch(ARCH)), jnp.float32)))
    cache = A.init_mla_cache(cfg, 1, 4, torch.float32)
    ptrs = (cache["c_kv"].data_ptr(), cache["k_rope"].data_ptr())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 1, cfg.d_model))
                         .astype(np.float32))
    _, c2 = A.mla_forward(cfg, p, x, positions=torch.tensor([2]), theta=cfg.rope_theta,
                          cache=cache, cache_pos=2)
    assert c2 is cache and (cache["c_kv"].data_ptr(), cache["k_rope"].data_ptr()) == ptrs
    assert cache["c_kv"][0, 2].abs().sum() > 0 and cache["k_rope"][0, 2].abs().sum() > 0
    assert not cache["c_kv"][0, [0, 1, 3]].any() and not cache["k_rope"][0, [0, 1, 3]].any()


# --- the wrappers' CUDA paths, as far as the CPU reaches them --------------------


def _on_the_card():
    """Every tensor claims to lie on a card, so a wrapper takes its CUDA
    path; ``_lib.launch`` records its arguments in place of a launch."""
    return mock.patch.object(torch.Tensor, "is_cuda", new=property(lambda self: True))


def test_instances_and_variants():
    assert FA._variant(torch.bfloat16, 4096, 192, 128) == "sm90"
    assert FA._variant(torch.float32, 4096, 192, 128) == "tf32x3"
    assert FA._variant(torch.bfloat16, 4096, 48, 32) == "tf32x3"
    assert FA._variant(torch.bfloat16, 1, 192, 128) == "decode"
    assert (192, 128) in FA._instances("sm90") and (192, 128) in FA._instances("tf32x3")
    assert (192, 128) not in FA._instances("decode")
    assert FA.sm90_launches == dict.fromkeys(FA.SM90_INSTANCES, 0)


def test_cuda_calls_at_the_reduced_mla_dims_raise():
    """No CUDA instance takes the reduced config's dims (q and k 48, v 32;
    latent 32 + 16): such a call raises before any launch, and is never
    padded to another instance."""
    q, ckv, krope = _latent_inputs(2, 40, 4, 32, 16, torch.float32)
    with _on_the_card(), mock.patch.object(_lib, "launch") as launch:
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="takes"):
                FA.flash_attention(torch.zeros((1, 8, 4, 48), dtype=dt),
                                   torch.zeros((1, 8, 4, 48), dtype=dt),
                                   torch.zeros((1, 8, 4, 32), dtype=dt))
        with pytest.raises(ValueError, match="takes"):
            FA.latent_decode(q, ckv, krope, scale=48**-0.5, q_offset=3)
        # one query at 192 / 128: the decode kernel takes only Hv == H
        with pytest.raises(ValueError, match="takes"):
            FA.flash_attention(torch.zeros((1, 1, 16, 192)), torch.zeros((1, 8, 16, 192)),
                               torch.zeros((1, 8, 16, 128)))
    assert launch.call_count == 0


def test_latent_decode_launch_arguments():
    """At deepseek-v2-lite-16b's serving shape (8 sequences, 16 heads, a
    4096-row cache whose leaves are views of one buffer), the wrapper hands
    the kernel both pointers with their strides, the plan of
    ``_latent_plan`` and a workspace for the merge when there is more than
    one split: at q_offset 0 and 63 one split of 64 keys across 4
    value-column groups (32 blocks, no workspace), at 127 two splits x 4
    groups (64 blocks), at 4095 16 splits of 256 keys (128 blocks); it
    counts each launch as flash_attention's and as the
    ``latent_decode`` variant. It refuses a q that is not fp32 (C6) and a
    leaf whose last axis is strided."""
    q, ckv, krope = _latent_inputs(8, 4096, 16, 512, 64, torch.bfloat16)
    q = q.float()
    want = {0: (64, 1, 4), 63: (64, 1, 4), 127: (64, 2, 4), 4095: (256, 16, 1)}
    ops.reset_launches()
    workspaces = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        workspaces.append(t)
        return t

    with _on_the_card(), mock.patch.object(_lib, "launch") as launch:
        for qo in want:
            with mock.patch.object(torch, "empty", side_effect=empty):
                out = FA.latent_decode(q, ckv, krope, scale=192**-0.5, q_offset=qo)
            assert out.shape == (8, 1, 16, 512) and out.dtype == torch.float32
        with pytest.raises(TypeError):
            FA.latent_decode(q.bfloat16(), ckv, krope, scale=192**-0.5, q_offset=5)
        strided = torch.zeros((8, 4096, 128), dtype=torch.bfloat16)[..., ::2]
        with pytest.raises(ValueError, match="unit stride"):
            FA.latent_decode(q, ckv, strided, scale=192**-0.5, q_offset=5)
    assert launch.call_count == len(want)
    for (qo, plan), (args, kw), ws in zip(want.items(), launch.call_args_list, workspaces):
        assert args[0] == "flash_attention_latent_decode"
        assert kw.keys() == {"count_as", "flops", "scratch"}
        assert kw["count_as"] == "flash_attention" and len(kw["scratch"]) == 1
        assert kw["scratch"][0] is ws
        assert kw["flops"]() == FA.latent_decode_flops(8, 16, 4096, 512, 64, qo)
        (q_ptr, ckv_ptr, kr_ptr, _, ws_ptr, B, S, N, cbs, crs, kbs, krs, is_bf16, got_qo,
         scale, chunk, splits, vsplits) = args[2:]
        assert (q_ptr, ckv_ptr, kr_ptr) == (q.data_ptr(), ckv.data_ptr(), krope.data_ptr())
        assert kr_ptr - ckv_ptr == 512 * 2
        assert (B, S, N, cbs, crs, kbs, krs, is_bf16, got_qo) == (
            8, 4096, 16, 4096 * 576, 576, 4096 * 576, 576, 1, qo)
        assert (chunk, splits, vsplits) == plan and scale == pytest.approx(192**-0.5)
        assert ws_ptr == ws.data_ptr() and ws.dtype == torch.float32
        assert ws.numel() == (8 * 16 * splits * (512 + 2) if splits > 1 else 0)
    assert FA.variant_launches["latent_decode"] == len(want)


def _c_params(entry: str) -> list[str]:
    for src in CSRC.glob("*.cu"):
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src.read_text())
        if m:
            return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    raise AssertionError(f"no C entry {entry}")


C_TO_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "cudaStream_t": ctypes.c_void_p, "int": ctypes.c_int,
               "long long": ctypes.c_longlong, "float": ctypes.c_float,
               "int*": ctypes.POINTER(ctypes.c_int),
               "long long*": ctypes.POINTER(ctypes.c_longlong)}


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_sm90",
                                   "flash_attention_sm90_attrs", "flash_attention_attrs",
                                   "flash_attention_latent_decode",
                                   "flash_attention_latent_decode_attrs",
                                   "flash_attention_decode", "flash_attention_empty_rows"])
def test_ctypes_signatures_match_the_c_entries(entry):
    """Each attention entry's ctypes argument types are its C parameters'
    (a pointer or a 64-bit int passed as a 32-bit int would be cut)."""
    want = [C_TO_CTYPES[p.replace(" *", "*")] for p in _c_params(entry)]
    assert list(_lib._SIGNATURES[entry]) == want
