"""The port's Mamba2 block and zamba2-7b's shared attention block against the
JAX package's (``repro.models.ssm``, ``repro.models.transformer``), from
the reference's parameters converted with ``lm_from_jax`` and the same
numpy inputs, on the reduced architecture (d_model 128, d_inner 256, 8
heads of 32, state 16).

The reference scans the Mamba2 recurrence step by step (``lax.scan``, no
Pallas kernel). The port runs that step at S = 1 (``ref.mamba2_scan_ref``)
and the chunked SSD form beyond (``ssm.mamba2_scan_chunked``), the same
function in another association: fp32 outputs within 1e-4 (fp32 sums in
other orders), states within 1e-4 too.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as JS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.kernels import ref as R
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (
    ModelOpts,
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
)
from repro_torch.tree import tree_map

TOL = 1e-4
ARCH = "zamba2-7b"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def _cfgs():
    return jax_reduced(jax_get_arch(ARCH)), reduced(get_arch(ARCH))


def _mamba_params(seed, jcfg, dtype=jnp.float32, decay_shift=0.0):
    """The reference's init with its zero-initialised leaves drawn nonzero,
    so that every term of the block counts."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, JS.init_mamba2(jax.random.PRNGKey(seed), jcfg, dtype))
    for k in ("conv_b_x", "conv_b_BC", "norm_scale"):
        jp[k] = (rng.standard_normal(jp[k].shape) * 0.3).astype(np.float32)
    jp["dt_bias"] = (rng.standard_normal(jp["dt_bias"].shape) * 0.5 + decay_shift).astype(
        np.float32)
    jp["D"] = (rng.standard_normal(jp["D"].shape) * 0.5 + 1.0).astype(np.float32)
    return jp


def _jax_block(jcfg):
    return jax.jit(lambda p, x, st: JS.mamba2_block(jcfg, p, x, st))


def _state(seed, jcfg, B):
    rng = np.random.default_rng(seed)
    want = JS.init_mamba2_state(jcfg, B)
    return {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32) for k, v in want.items()}


def test_params_and_state_have_the_reference_layout():
    jcfg, cfg = _cfgs()
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = JS.init_mamba2(jax.random.PRNGKey(0), jcfg, dtype)
        got = S.init_mamba2(torch.Generator().manual_seed(0), cfg, tdtype)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert {k: str(v.dtype)[6:] for k, v in got.items()} == \
            {k: str(v.dtype) for k, v in want.items()}
        _close(got["A_log"], want["A_log"], 1e-6)  # linspace rounds otherwise by an ulp
    want = JS.init_mamba2_state(jcfg, 3)
    got = S.init_mamba2_state(cfg, 3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 and not v.any() for v in got.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_", [1, 2, 7])
def test_causal_conv_with_a_state(dtype, S_):
    """A nonzero fp32 conv state: the reference casts it to u's dtype before
    use, so on bf16 the new state (cast back to fp32 by the block) holds
    bf16-rounded values; the port keeps that cast, and the state is held bit
    for bit. bf16 outputs within two bf16 ulps of |want| plus 2^-8 (a few
    ulps of the taps' sum, whose scale is 1): each side rounds every op to
    bf16, but XLA's bf16 logistic rounds otherwise than torch's sigmoid
    (about 70% of them bit-equal alone)."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(S_)
    W, Cn = jcfg.conv_width, 24
    w = (rng.standard_normal((W, Cn)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((Cn,)) * 0.3).astype(np.float32)
    u = rng.standard_normal((2, S_, Cn)).astype(np.float32)
    st = rng.standard_normal((2, W - 1, Cn)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, want_st = JS._causal_conv(jnp.asarray(w, jdt), jnp.asarray(b), jnp.asarray(u, jdt),
                                      jnp.asarray(st))
    got_y, got_st = S._causal_conv(torch.from_numpy(w).to(tdt), torch.from_numpy(b),
                                   torch.from_numpy(u).to(tdt), torch.from_numpy(st))
    assert got_y.dtype == tdt and got_st.dtype == tdt
    want_y = np.asarray(want_y.astype(jnp.float32))
    want_st = np.asarray(want_st.astype(jnp.float32))
    tol = 2.0**-6 * np.abs(want_y) + 2.0**-8 if dtype == "bfloat16" else TOL
    np.testing.assert_array_less(np.abs(got_y.float().numpy() - want_y), tol + 1e-12)
    np.testing.assert_array_equal(got_st.float().numpy(), want_st)
    # the new state is the last W - 1 inputs rounded to u's dtype: on bf16
    # the fp32 state's rows lose their low bits
    last = np.concatenate([st, u], axis=1)[:, -(W - 1):]
    np.testing.assert_array_equal(got_st.float().numpy(),
                                  torch.from_numpy(last).to(tdt).float().numpy())
    assert np.array_equal(got_st.float().numpy(), last) == (dtype == "float32")


@pytest.mark.parametrize("S_", [1, 5, 64, 100])
def test_mamba2_block_matches_the_reference(S_):
    """Output and all three state leaves from a nonzero initial state; 100
    is no multiple of the chunk (a padded last chunk)."""
    jcfg, cfg = _cfgs()
    jp = _mamba_params(S_, jcfg)
    st = _state(S_ + 1, jcfg, 2)
    x = np.random.default_rng(S_ + 2).standard_normal((2, S_, cfg.d_model)).astype(np.float32)
    want, want_st = _jax_block(jcfg)(jp, x, st)
    got, got_st = S.mamba2_block(cfg, lm_from_jax(jp), torch.from_numpy(x), lm_from_jax(st))
    _close(got, want)
    assert set(got_st) == set(want_st)
    for k in want_st:
        assert got_st[k].dtype == torch.float32
        _close(got_st[k], want_st[k])


def test_strong_decay_stays_finite_and_matches_the_reference():
    """dt_bias + 10 and A_log up to log 16 * 3: a decay exp(dt A) of about
    e^-10 to e^-480 a step, which underflows; the chunked form's exponents
    are all <= 0, so nothing overflows (unlike rwkv6's, ROADMAP C12)."""
    jcfg, cfg = _cfgs()
    jp = _mamba_params(7, jcfg, decay_shift=10.0)
    jp["A_log"] = (jp["A_log"] * 3.0).astype(np.float32)
    st = _state(8, jcfg, 2)
    x = np.random.default_rng(9).standard_normal((2, 130, cfg.d_model)).astype(np.float32)
    want, want_st = _jax_block(jcfg)(jp, x, st)
    got, got_st = S.mamba2_block(cfg, lm_from_jax(jp), torch.from_numpy(x), lm_from_jax(st))
    assert torch.isfinite(got).all() and torch.isfinite(got_st["s"]).all()
    _close(got, want)
    _close(got_st["s"], want_st["s"])


@pytest.mark.parametrize("S_,chunk", [(1, 64), (5, 64), (64, 64), (100, 64), (130, 16),
                                      (200, 64), (33, 8)])
def test_chunked_scan_matches_the_exact_recurrence(S_, chunk):
    """``mamba2_scan_chunked`` against ``ref.mamba2_scan_ref`` from a
    nonzero state, y and the final state, and both against the recurrence
    in fp64: the chunked form is no further from it than the exact one."""
    g = torch.Generator().manual_seed(S_)
    B, H, P, N = 2, 4, 8, 6
    x = torch.randn((B, S_, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S_, H), generator=g))
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = torch.randn((B, S_, N), generator=g), torch.randn((B, S_, N), generator=g)
    s0 = torch.randn((B, H, P, N), generator=g)
    want_y, want_s = R.mamba2_scan_ref(x, dt, A, Bm, Cm, s0)
    got_y, got_s = S.mamba2_scan_chunked(x, dt, A, Bm, Cm, s0, chunk=chunk)
    torch.testing.assert_close(got_y, want_y, rtol=0, atol=TOL)
    torch.testing.assert_close(got_s, want_s, rtol=0, atol=TOL)
    y64, _ = R.mamba2_scan_ref(*(t.double() for t in (x, dt, A, Bm, Cm, s0)),
                               dtype=torch.float64)
    err_exact = (want_y.double() - y64).abs().max().item()
    err_chunked = (got_y.double() - y64).abs().max().item()
    assert err_chunked <= max(4 * err_exact, 1e-5), (err_chunked, err_exact)


def test_prefill_then_decode_equals_the_full_prefill():
    """The block over 70 tokens at once, and over its first 67 then three
    single steps from the carried state (the exact step), agree."""
    jcfg, cfg = _cfgs()
    p = lm_from_jax(_mamba_params(11, jcfg))
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 70, cfg.d_model)).astype(np.float32))
    st = S.init_mamba2_state(cfg, 2)
    full, full_st = S.mamba2_block(cfg, p, x, st)
    part, st2 = S.mamba2_block(cfg, p, x[:, :67], st)
    outs = [part]
    for t in range(67, 70):
        y, st2 = S.mamba2_block(cfg, p, x[:, t:t + 1], st2)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=TOL)
    for k in full_st:
        torch.testing.assert_close(st2[k], full_st[k], rtol=0, atol=TOL)


# --- zamba2-7b: the shared block --------------------------------------------


@pytest.fixture(scope="module")
def two_repeats():
    """Reduced zamba2-7b at n_repeats 2 (reduced keeps 1): 2 x (5 mamba2 +
    the shared block) + 1 tail mamba2, the reference's params converted."""
    jcfg, cfg = _cfgs()
    jcfg = replace(jcfg, n_repeats=2, num_layers=13)
    cfg = replace(cfg, n_repeats=2, num_layers=13)
    jo = JaxOpts(remat=False)
    jp = jax_init_params(jax.random.PRNGKey(5), jcfg, jo)
    pre = jax.jit(lambda prm, toks: jax_prefill(jcfg, jo, prm, {"tokens": toks}))
    dec = jax.jit(lambda prm, tok, pos, c: jax_decode(jcfg, jo, prm,
                                                      {"token": tok, "pos": pos}, c))
    return jcfg, cfg, (pre, dec), jp, lm_from_jax(jax.tree.map(np.asarray, jp))


def test_the_shared_block_has_one_copy(two_repeats):
    jcfg, cfg, jo, jp, p = two_repeats
    mine = init_params(cfg, ModelOpts(), seed=0, device="cpu")
    assert tree_map(lambda t: tuple(t.shape), mine) == jax.tree.map(lambda a: tuple(a.shape), jp)
    assert set(mine["shared"]) == {"shared_attn"}
    assert set(mine["shared"]["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    assert mine["shared"]["shared_attn"]["attn"]["wq"].dim() == 2  # no repeat axis
    assert set(mine["unit"]) == {f"blk{i}" for i in range(5)}  # no shared position
    assert mine["unit"]["blk0"]["mamba"]["wz"].shape[0] == 2  # stacked over the repeats


def test_each_occurrence_writes_its_own_cache_slot(two_repeats):
    jcfg, cfg, jo, jp, p = two_repeats
    c = init_cache(cfg, ModelOpts(), 2, 8, torch.float32, device="cpu")
    assert c["unit"]["blk5"]["k"].shape == (2, 2, 8, cfg.num_kv_heads, cfg.head_dim)
    toks = torch.ones((2, 1), dtype=torch.long)
    forward_decode(cfg, ModelOpts(), p, {"token": toks, "pos": 3}, c)
    k = c["unit"]["blk5"]["k"]
    # each occurrence wrote slot 3 of its own cache, and nothing else
    assert k[:, :, 3].abs().amax(dim=(1, 2, 3)).gt(0).all()
    assert not k[:, :, [0, 1, 2, 4, 5, 6, 7]].any()
    # the two occurrences see different inputs, so their keys differ
    assert not torch.equal(k[0, :, 3], k[1, :, 3])


def test_two_repeats_match_the_reference(two_repeats):
    jcfg, cfg, jo, jp, p = two_repeats
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 70)).astype(np.int32)
    pre, dec = jo
    want = pre(jp, jnp.asarray(toks))
    got = forward_prefill(cfg, ModelOpts(), p, {"tokens": torch.from_numpy(toks).long()})
    _close(got, want)
    jc = jax_init_cache(jcfg, JaxOpts(remat=False), 2, 8, jnp.float32)
    c = init_cache(cfg, ModelOpts(), 2, 8, torch.float32, device="cpu")
    for t in range(6):
        want, jc = dec(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
        got, c = forward_decode(cfg, ModelOpts(), p,
                                {"token": torch.from_numpy(toks[:, t:t + 1]).long(),
                                 "pos": t}, c)
        _close(got, want)
    for k in ("k", "v"):
        _close(c["unit"]["blk5"][k], jc["unit"]["blk5"][k])
    for k in ("conv_x", "conv_BC", "s"):
        _close(c["unit"]["blk2"][k], jc["unit"]["blk2"][k])
        _close(c["tail"][0][k], jc["tail"][0][k])


def test_ssm_seq_chunk_prefill_matches_the_reference():
    """``ModelOpts.ssm_seq_chunk`` cuts each mamba2 block's sequence into
    chunks with the state carried between them, as the reference's
    chunked-remat time scan: prefill logits equal the reference's with the
    same option."""
    jcfg, cfg = _cfgs()
    jo = JaxOpts(remat=False, ssm_seq_chunk=16)
    jp = jax_init_params(jax.random.PRNGKey(8), jcfg, jo)
    p = lm_from_jax(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 48)).astype(np.int32)
    want = jax.jit(lambda prm, t: jax_prefill(jcfg, jo, prm, {"tokens": t}))(
        jp, jnp.asarray(toks))
    got = forward_prefill(cfg, ModelOpts(ssm_seq_chunk=16), p,
                          {"tokens": torch.from_numpy(toks).long()})
    _close(got, want)
