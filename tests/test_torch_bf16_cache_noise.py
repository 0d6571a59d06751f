"""Why a bf16 KV cache may differ from the reference's by one bf16 step,
and why the logits of free runs then drift apart.

A decode step writes each new key and value into the cache rounded to bf16
from an fp32 number. The port and the JAX package compute that number with
sums in other orders, so the two fp32 numbers differ by fp32 noise. Where
the exact value lies within that noise of a midpoint between two bf16
numbers, the packages round to the two sides of it, and the caches differ
by one bf16 step there. zamba2-7b shows it: its mamba2 blocks feed the
shared attention block's keys and values through fp32 recurrences, and one
to three of its 1,536 cached elements differ by one step for most draws of
its weights. (The reference draws the shared block from a key folded with
``hash(kind)``, which Python salts per process, so each process tests
other weights.)

The first test shows it for every element where it happens: the same eight
decode steps as ``test_torch_lm_models.test_decode_logits`` with a bf16
cache, at one torch thread, with each step's fp32 keys and values
captured in both packages before their rounding, and the port's run once
more with every fp32 operation in fp64 (``torch.float32`` read as
``torch.float64`` while it runs, so the norms, the scan and attention run
in fp64 too; the cache stays bf16). Both packages' fp32 numbers lie within
``NOISE_ULPS`` fp32 ulps of the leaf's largest magnitude of the fp64
numbers, at every element; and at each element where the caches differ,
they are adjacent bf16 numbers whose midpoint lies within that noise of
the fp64 number, with the two fp32 numbers on its two sides. That is the
bar ``_close_bf16_cache`` holds such leaves to.

The second shows that the logits' drift comes from those elements alone:
read from one bf16 cache, both packages' logits lie within fp32 noise of
the fp64 ones."""
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro_torch.kernels.flash_attention as FA
import repro_torch.models.attention as A
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import forward_decode as jax_decode
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.models.layers import apply_rope, mm, rope_angles
from repro_torch.models.transformer import (
    ATTN_KINDS,
    ModelOpts,
    forward_decode,
    init_cache,
)
from repro_torch.tree import tree_map

TOL = 1e-4  # test_torch_lm_models' bound
NOISE_ULPS = 32  # fp32 ulps of the leaf's largest |k| or |v|; at most 16.3 measured
STEPS, CACHE = 8, 12


@contextmanager
def _torch_threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _jax_kv(cfg, params, x, positions, theta):
    """k (with RoPE) and v as the reference's ``attn_forward`` computes them."""
    k = JA._split_heads(x @ params["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = JA._split_heads(x @ params["wv"], cfg.num_kv_heads, cfg.head_dim)
    return JA.apply_rope(k, *JA.rope_angles(positions, cfg.head_dim, theta)), v


def _port_kv(cfg, params, x, positions, theta):
    """k (with RoPE) and v as the port's ``attn_forward`` computes them."""
    k = A._split_heads(mm(x, params["wk"]), cfg.num_kv_heads, cfg.head_dim)
    v = A._split_heads(mm(x, params["wv"]), cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(k, *rope_angles(positions, cfg.head_dim, theta)), v


def _next_bf16_up(x: float) -> float:
    """The bf16 number right above bf16 number ``x``."""
    bits = torch.tensor([x], dtype=torch.bfloat16).view(torch.int16)
    bits = bits + (1 if x >= 0 else -1) if x != 0 else torch.tensor([1], dtype=torch.int16)
    return float(bits.view(torch.bfloat16).float())


def _reference_run(jcfg, toks, monkeypatch):
    """The reference's cache after the steps, and each step's fp32 (k, v)."""
    jo = JaxOpts(remat=False)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg, jo)
    caught = []
    orig = JA.attn_forward

    def capture(cfg, params, x, *, positions, theta, **kw):
        y, c = orig(cfg, params, x, positions=positions, theta=theta, **kw)
        if kw.get("cache") is not None:
            k, v = _jax_kv(cfg, params, x, positions, theta)
            jax.debug.callback(lambda k, v: caught.append((np.asarray(k), np.asarray(v))),
                               k, v)
        return y, c

    monkeypatch.setattr(JA, "attn_forward", capture)
    dec = jax.jit(lambda prm, tok, pos, c: jax_decode(jcfg, jo, prm,
                                                      {"token": tok, "pos": pos}, c))
    jc = jax_init_cache(jcfg, jo, 2, CACHE, jnp.bfloat16)
    for t in range(STEPS):
        _, jc = dec(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
    jax.effects_barrier()
    monkeypatch.setattr(JA, "attn_forward", orig)
    return jp, jc, caught


def _port_run(cfg, params, toks, monkeypatch, state_dtype):
    """The port's cache after the steps, and each step's (k, v) before the
    bf16 rounding; the recurrent states in ``state_dtype``."""
    caught = []
    orig = A.attn_forward

    def capture(cfg_, p, x, *, positions, theta, **kw):
        caught.append(_port_kv(cfg_, p, x, positions, theta))
        return orig(cfg_, p, x, positions=positions, theta=theta, **kw)

    opts = ModelOpts()
    with monkeypatch.context() as m:
        m.setattr(A, "attn_forward", capture)
        c = init_cache(cfg, opts, 2, CACHE, torch.bfloat16, device="cpu")
        c = tree_map(lambda t: t.to(state_dtype) if t.dtype == torch.float32 else t, c)
        for t in range(STEPS):
            forward_decode(cfg, opts, params, {"token": torch.from_numpy(toks[:, t:t + 1])
                                               .long(), "pos": t}, c)
    return c, caught


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-small"])
def test_off_elements_of_a_bf16_cache_are_fp32_noise(arch, monkeypatch):
    jcfg = jax_reduced(jax_get_arch(arch))
    cfg = reduced(get_arch(arch))
    (i,) = [i for i, b in enumerate(cfg.pattern) if b.kind in ATTN_KINDS]
    assert cfg.n_repeats == 1 and not any(b.kind in ATTN_KINDS
                                          for b in cfg.head_blocks + cfg.tail_blocks)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, STEPS)).astype(np.int32)
    jp, jc, want32 = _reference_run(jcfg, toks, monkeypatch)
    p = lm_from_jax(jax.tree.map(np.asarray, jp))
    with _torch_threads(1):
        c, got32 = _port_run(cfg, p, toks, monkeypatch, torch.float32)
        # every fp32 operation of the port in fp64: the same code, read with
        # torch.float32 meaning torch.float64 (the flash wrapper's plain
        # version then takes fp64 too)
        p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, p)
        with monkeypatch.context() as m:
            m.setattr(torch, "float32", torch.float64)
            m.setattr(FA, "DTYPES", (torch.float64, torch.bfloat16))
            _, exact = _port_run(cfg, p64, toks, monkeypatch, torch.float64)
    assert len(want32) == len(got32) == len(exact) == STEPS
    n_off = 0
    for j, name in enumerate(("k", "v")):
        X = np.stack([e[j].numpy() for e in exact])  # (steps, B, 1, K, H) fp64
        P = np.stack([g[j].numpy() for g in got32]).astype(np.float64)
        J = np.stack([w[j] for w in want32]).astype(np.float64)
        assert X.dtype == np.float64 and P.shape == J.shape == X.shape
        noise = NOISE_ULPS * np.spacing(np.float32(np.abs(X).max()))
        assert np.abs(P - X).max() <= noise and np.abs(J - X).max() <= noise
        g = c["unit"][f"blk{i}"][name][0, :, :STEPS].float().numpy()  # (B, steps, K, H)
        w = np.asarray(jc["unit"][f"blk{i}"][name][0, :, :STEPS].astype(jnp.float32))
        for b, s, kh, h in np.argwhere(np.abs(g - w) > TOL):
            n_off += 1
            lo, hi = sorted((g[b, s, kh, h], w[b, s, kh, h]))
            assert hi == _next_bf16_up(lo), (lo, hi)  # adjacent bf16 numbers
            mid = (np.float64(lo) + np.float64(hi)) / 2
            x, pp, jj = X[s, b, 0, kh, h], P[s, b, 0, kh, h], J[s, b, 0, kh, h]
            assert abs(x - mid) <= noise
            assert (pp - mid) * (jj - mid) <= 0  # the two fp32 numbers straddle it
    assert n_off < 0.01 * 2 * g.size


def test_logits_read_from_one_bf16_cache_are_fp32_noise(monkeypatch):
    """zamba2-7b's logits drift apart over free runs of the two packages
    (by up to 3e-4 in eight steps for some of the reference's draws of its
    shared block), and this shows the drift to be the cache's roundings: at
    each of the eight steps, the port's fp32 logits and those of the
    reference reading the port's bf16 cache (``test_decode_logits``'
    comparison) both lie within ``NOISE_ULPS`` fp32 ulps of the step's
    largest |logit| of the port's logits with every fp32 operation in fp64,
    reading that cache too; the test above shows the cache elements where
    the packages' own caches differ to be fp32 noise."""
    from test_torch_lm_models import _reference_reading

    from repro_torch.kernels import ops

    arch = "zamba2-7b"
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    (i,) = [i for i, b in enumerate(cfg.pattern) if b.kind in ATTN_KINDS]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, STEPS)).astype(np.int32)
    jo = JaxOpts(remat=False)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg, jo)
    p = lm_from_jax(jax.tree.map(np.asarray, jp))
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, p)
    opts = ModelOpts()
    jc = jax_init_cache(jcfg, jo, 2, CACHE, jnp.bfloat16)
    c = init_cache(cfg, opts, 2, CACHE, torch.bfloat16, device="cpu")
    c64 = tree_map(lambda t: t.double() if t.dtype == torch.float32 else t,
                   init_cache(cfg, opts, 2, CACHE, torch.bfloat16, device="cpu"))
    dec = _reference_reading(jcfg, cfg, c, monkeypatch)
    forced = []
    orig = ops.flash_attention

    def flash_attention(q, k, v, **kw):
        if forced:  # the fp64 run's decode read: the port's bf16 cache
            k, v = (t.to(q.dtype) for t in forced.pop())
        return orig(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", flash_attention)
    for t in range(STEPS):
        tok = torch.from_numpy(toks[:, t:t + 1]).long()
        got, _ = forward_decode(cfg, opts, p, {"token": tok, "pos": t}, c)
        want, jc = dec(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
        forced.append((c["unit"][f"blk{i}"]["k"][0], c["unit"][f"blk{i}"]["v"][0]))
        with monkeypatch.context() as m:
            m.setattr(torch, "float32", torch.float64)
            m.setattr(FA, "DTYPES", (torch.float64, torch.bfloat16))
            exact, _ = forward_decode(cfg, opts, p64, {"token": tok, "pos": t}, c64)
        assert not forced and exact.dtype == torch.float64
        x = exact.numpy()
        noise = NOISE_ULPS * np.spacing(np.float32(np.abs(x).max()))
        assert np.abs(got.numpy() - x).max() <= noise, t
        assert np.abs(np.asarray(want, np.float64) - x).max() <= noise, t
