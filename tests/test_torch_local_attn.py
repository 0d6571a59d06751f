"""gemma3-12b's sliding-window layers in the port against the JAX package,
on reduced gemma3-12b (5 ``local_attn`` layers with a 32-token window and
RoPE base 10,000, then one global ``attn`` layer with base 1,000,000;
QK-norm; GeGLU; tied embeddings), from the reference's parameters
converted with ``lm_from_jax``, the QK-norm scales set away from their
zero init: prefill longer than the window and decode past it within 1e-4,
and a port whose window or RoPE bases are changed fails that bound. Also
``with_long_variant``, the reference's sliding-window variant of a dense
model."""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.configs import with_long_variant as jax_with_long_variant
from repro.models import ModelOpts as JaxOpts
from repro.models import attention as JA
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_arch, reduced, with_long_variant
from repro_torch.convert import lm_from_jax
from repro_torch.models import attention as A
from repro_torch.models.transformer import (
    ModelOpts,
    forward_decode,
    forward_prefill,
    init_cache,
)

TOL = 1e-4
ARCH = "gemma3-12b"
S = 48  # past the reduced config's 32-token window


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _with_qk_scales(jp, rng):
    """The params with every q_norm / k_norm scale drawn away from 0."""
    if isinstance(jp, dict):
        return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.5
                    if k in ("q_norm", "k_norm") else _with_qk_scales(v, rng))
                for k, v in jp.items()}
    if isinstance(jp, list):
        return [_with_qk_scales(v, rng) for v in jp]
    return jp


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_arch(ARCH))
    cfg = reduced(get_arch(ARCH))
    assert cfg.sliding_window == 32 and cfg.qk_norm
    assert [b.kind for b in cfg.blocks] == ["local_attn"] * 5 + ["attn"]
    jo = JaxOpts(remat=False)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg, jo))
    jp = _with_qk_scales(jp, np.random.default_rng(7))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    pre = jax.jit(lambda prm, t: jax_prefill(jcfg, jo, prm, {"tokens": t}))
    want_pre = np.asarray(pre(jax.tree.map(jnp.asarray, jp), jnp.asarray(toks)))
    dec = jax.jit(lambda prm, tok, pos, c: jax_decode(jcfg, jo, prm,
                                                      {"token": tok, "pos": pos}, c))
    jc = jax_init_cache(jcfg, jo, 2, S, jnp.float32)
    want_dec = []
    for t in range(S):
        lg, jc = dec(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
        want_dec.append(np.asarray(lg))
    return cfg, lm_from_jax(jp), toks, want_pre, np.stack(want_dec)


def _prefill(cfg, p, toks):
    return forward_prefill(cfg, ModelOpts(), p, {"tokens": torch.from_numpy(toks).long()})


def _decode(cfg, p, toks):
    c = init_cache(cfg, ModelOpts(), 2, S, torch.float32, device="cpu")
    out = []
    for t in range(S):
        lg, c = forward_decode(cfg, ModelOpts(), p,
                               {"token": torch.from_numpy(toks[:, t:t + 1]).long(), "pos": t},
                               c)
        out.append(lg.numpy())
    return np.stack(out)


def test_windowed_prefill_matches_the_reference(model):
    cfg, p, toks, want, _ = model
    np.testing.assert_allclose(_prefill(cfg, p, toks).numpy(), want, rtol=0, atol=TOL)


def test_decode_past_the_window_matches_the_reference(model):
    """48 decode steps: from position 32 on, each local layer attends to
    its last 32 keys of the full-length cache."""
    cfg, p, toks, _, want = model
    got = _decode(cfg, p, toks)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[-1], _prefill(cfg, p, toks).numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("change", [
    dict(sliding_window=0),  # every layer global
    dict(sliding_window=S),  # a window the sequence never passes
    dict(rope_theta=10_000.0, local_rope_theta=1_000_000.0),  # the two bases swapped
    dict(local_rope_theta=0.0),  # the local layers on the global base
], ids=["no_window", "wide_window", "bases_swapped", "one_base"])
def test_a_port_with_another_window_or_base_fails_the_parity(model, change):
    """The bound tells the window and the two RoPE bases apart: changing
    either moves the logits past 1e-4 of the reference's, at prefill and
    at the decode steps past the window."""
    cfg, p, toks, want_pre, want_dec = model
    other = replace(cfg, **change)
    assert np.abs(_prefill(other, p, toks).numpy() - want_pre).max() > 10 * TOL
    assert np.abs(_decode(other, p, toks)[32:] - want_dec[32:]).max() > 10 * TOL


@pytest.mark.parametrize("window,pos", [(0, 20), (8, 20), (8, 5), (32, 40)])
def test_local_attn_forward_with_qk_norm(window, pos):
    """attn_forward with QK-norm (non-zero scales), a window and gemma3's
    local base, at prefill and at one decode step, against the reference's."""
    jcfg = jax_reduced(jax_get_arch(ARCH))
    cfg = reduced(get_arch(ARCH))
    rng = np.random.default_rng(window + pos)
    jp = jax.tree.map(np.asarray, JA.init_attn(jax.random.PRNGKey(1), jcfg, jnp.float32))
    jp = _with_qk_scales(jp, rng)
    jpj, p = jax.tree.map(jnp.asarray, jp), lm_from_jax(jp)
    theta = cfg.local_rope_theta
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want, _ = JA.attn_forward(jcfg, jpj, jnp.asarray(x), positions=jnp.arange(24),
                              theta=theta, window=window)
    got, _ = A.attn_forward(cfg, p, torch.from_numpy(x), positions=torch.arange(24),
                            theta=theta, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    x1 = x[:, :1]
    cache = {k: rng.standard_normal((2, 48, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
             for k in ("k", "v")}
    want, want_c = JA.attn_forward(jcfg, jpj, jnp.asarray(x1), positions=jnp.asarray([pos]),
                                   theta=theta, window=window,
                                   cache=jax.tree.map(jnp.asarray, cache),
                                   cache_pos=jnp.asarray(pos))
    c = lm_from_jax(cache)
    got, _ = A.attn_forward(cfg, p, torch.from_numpy(x1), positions=torch.tensor([pos]),
                            theta=theta, window=window, cache=c, cache_pos=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(want_c["k"]), rtol=0, atol=TOL)


def test_with_long_variant_is_the_references():
    """Every attn block becomes local_attn with an 8192-token window, as the
    reference's variant (tests/test_configs.py checks the reference's)."""
    for arch in ("llama3-8b", "nemotron-4-15b", "gemma3-12b"):
        mine = with_long_variant(get_arch(arch))
        want = jax_with_long_variant(jax_get_arch(arch))
        assert asdict(mine) == asdict(want)
    sw = with_long_variant(get_arch("llama3-8b"))
    assert sw.name == "llama3-8b-sw" and sw.sliding_window == 8192
    assert all(b.kind == "local_attn" for b in sw.pattern) and sw.long_context == "native"
    mine = with_long_variant(get_arch("gemma3-12b"), window=512)
    assert [b.kind for b in mine.pattern] == ["local_attn"] * 6 and mine.sliding_window == 512


def test_long_variant_prefill_matches_the_reference():
    """Reduced llama3-8b's sliding-window variant (every layer local, the
    reduced window of 32 tokens) against the reference's, past the window."""
    jcfg = jax_reduced(jax_with_long_variant(jax_get_arch("llama3-8b")))
    cfg = reduced(with_long_variant(get_arch("llama3-8b")))
    assert cfg.sliding_window == 32
    jo = JaxOpts(remat=False)
    jp = jax_init_params(jax.random.PRNGKey(2), jcfg, jo)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    want = jax_prefill(jcfg, jo, jp, {"tokens": jnp.asarray(toks)})
    got = _prefill(cfg, lm_from_jax(jax.tree.map(np.asarray, jp)), toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
