"""The port's LM modules against the JAX package's on the reduced
architectures the port serves (llama3.2-3b, rwkv6-1.6b, gemma3-12b with its
sliding-window layers and QK-norm, llama3-8b, nemotron-4-15b with LayerNorm
and squared ReLU, qwen2-moe-a2.7b with its MoE blocks, deepseek-v2-lite-16b
with MLA: its prefill held to the reference's expanded form, its decode to
the absorbed one, zamba2-7b with its mamba2 blocks and one shared attention
block, whisper-small's encoder-decoder with learned position embeddings,
its prefill with encoder frames and its decode against random encoder
states, llava-next-mistral-7b with a media prefix at prefill), from the
reference's parameters converted with ``lm_from_jax``
and the same numpy inputs: attention, the RWKV6 mixes, prefill and decode
logits within 1e-4 (fp32 through a few layers, sums in other orders). Also
the port's decode reproduces its own prefill, as the reference's smoke test
checks for the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import attention as JA
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as JS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.launch.steps import input_specs
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (
    ATTN_KINDS,
    ModelOpts,
    _encode,
    forward_decode,
    forward_prefill,
    init_cache,
    init_params,
)
from repro_torch.tree import tree_map

TOL = 1e-4
ARCHS = ["llama3.2-3b", "rwkv6-1.6b", "gemma3-12b", "llama3-8b", "nemotron-4-15b",
         "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "zamba2-7b", "whisper-small",
         "llava-next-mistral-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jcfg, cfg, jax params, port params, jitted jax prefill / decode)."""
    jcfg = jax_reduced(jax_get_arch(request.param))
    jo = JaxOpts(remat=False)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg, jo)
    p = lm_from_jax(jax.tree.map(np.asarray, jp))
    pre = jax.jit(lambda prm, batch: jax_prefill(jcfg, jo, prm, batch))
    dec = jax.jit(lambda prm, tok, pos, c: jax_decode(jcfg, jo, prm,
                                                      {"token": tok, "pos": pos}, c))
    return jcfg, reduced(get_arch(request.param)), jp, p, pre, dec


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _stubs(cfg, B, seed=0, dtype=np.float32):
    """The stubbed frontends' inputs of a prefill batch with ``input_specs``'
    shapes, standard normal: encoder frames (``enc_dec``), or
    ``num_media_tokens`` media rows (``vision_stub``, its split of twice
    that many positions); none for a text model."""
    rng = np.random.default_rng(seed + 100)
    specs = input_specs(cfg, B, 2 * cfg.num_media_tokens, "prefill")
    return {k: rng.standard_normal(tuple(s.shape)).astype(dtype)
            for k, s in specs.items() if k != "tokens"}


def _enc_out(cfg, B, seed=0):
    """Random encoder states for an encoder-decoder model's cache (the
    zeros ``init_cache`` gives would hide its cross attention)."""
    rng = np.random.default_rng(seed + 200)
    return rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)


def _fill_enc_out(cfg, jc, c, seed=0):
    """The same random encoder states into both packages' caches, in each
    cache's dtype; nothing for a model without an encoder."""
    if cfg.enc_dec:
        e = _enc_out(cfg, c["enc_out"].shape[0], seed)
        jc["enc_out"] = jnp.asarray(e).astype(jc["enc_out"].dtype)
        c["enc_out"].copy_(torch.from_numpy(e))
    return jc


def test_params_have_the_reference_layout(model):
    jcfg, cfg, jp, p, _, _ = model
    mine = init_params(cfg, ModelOpts(), seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tree_map(lambda t: tuple(t.shape), mine) == shapes
    assert tree_map(lambda t: t.dtype, mine) == tree_map(lambda t: t.dtype, p)


def test_prefill_logits(model):
    jcfg, cfg, jp, p, pre, _ = model
    toks, stubs = _tokens(cfg, 2, 12), _stubs(cfg, 2)
    want = pre(jp, {"tokens": jnp.asarray(toks), **jax.tree.map(jnp.asarray, stubs)})
    got = forward_prefill(cfg, ModelOpts(), p,
                          {"tokens": torch.from_numpy(toks).long(),
                           **{k: torch.from_numpy(v) for k, v in stubs.items()}})
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_logits(model, cache_dtype, monkeypatch):
    """Eight decode steps into a 12-long cache, the cache updated in place
    (an encoder-decoder model's against random encoder states). The fp32
    model also runs against a bf16 cache (both packages' default cache
    dtype), where attention computes in fp32 all the same. Each package
    runs on its own cache, and the caches are compared at the end.

    With a bf16 cache, a model with mamba2 blocks (zamba2-7b) is compared
    step by step from the same attention inputs: the reference's attention
    reads the port's bf16 cache (``_reference_reading``). Its mamba2 blocks
    feed the attention block's keys and values through fp32 sums that the
    two packages run in other orders, so an element of its bf16 cache may
    round to the other neighbour of a midpoint than the reference's
    (``_close_bf16_cache``); read at its own step and every later one, such
    an element moves the logits beyond TOL for some of the reference's
    draws of the shared block (its key comes from the process's salted
    ``hash``), by up to 3e-4 over eight steps.
    ``tests/test_torch_bf16_cache_noise.py`` shows both the elements and
    the logits' drift to be fp32 noise."""
    jcfg, cfg, jp, p, _, dec = model
    opts = ModelOpts()
    toks = _tokens(cfg, 2, 8, seed=1)
    jc = jax_init_cache(jcfg, JaxOpts(remat=False), 2, 12, getattr(jnp, cache_dtype))
    c = init_cache(cfg, opts, 2, 12, getattr(torch, cache_dtype), device="cpu")
    jc = _fill_enc_out(cfg, jc, c, seed=1)
    reads = cache_dtype == "bfloat16" and any(b.kind == "mamba2" for b in cfg.blocks)
    if reads:
        dec = _reference_reading(jcfg, cfg, c, monkeypatch)
    for t in range(8):
        got, c2 = forward_decode(cfg, opts, p,
                                 {"token": torch.from_numpy(toks[:, t:t + 1]).long(),
                                  "pos": t}, c)
        assert c2 is c
        want, jc = dec(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
        _close(got, want)
    # the caches agree too
    got_leaves, want_leaves = _leaves(c), _leaves(jc)
    assert len(got_leaves) == len(want_leaves)
    noisy = cache_dtype == "bfloat16" and (cfg.qk_norm or reads)
    for g, w in zip(got_leaves, want_leaves):
        if noisy and g.dtype == torch.bfloat16:
            _close_bf16_cache(g, w)
        else:
            _close(g, w)


def _reference_reading(jcfg, cfg, c, monkeypatch):
    """The reference's decode step, jitted, with its attention reading the
    port's cache ``c`` as it stands (the step's keys and values written)
    in place of its own; its own cache is written and returned as ever.
    For a reduced model with one attention occurrence a step."""
    (i,) = [i for i, b in enumerate(cfg.pattern) if b.kind in ATTN_KINDS]
    assert cfg.n_repeats == 1 and not any(b.kind in ATTN_KINDS
                                          for b in cfg.head_blocks + cfg.tail_blocks)
    slot = []
    orig = JA.mha

    def mha(q, k, v, *, valid_len=None, **kw):
        if valid_len is not None:  # a decode step's read of its cache
            k, v = slot.pop()
        return orig(q, k, v, valid_len=valid_len, **kw)

    monkeypatch.setattr(JA, "mha", mha)
    jo = JaxOpts(remat=False)

    def step(prm, tok, pos, jc, k, v):
        slot.append((k, v))
        out = jax_decode(jcfg, jo, prm, {"token": tok, "pos": pos}, jc)
        assert not slot
        return out

    step = jax.jit(step)
    port = c["unit"][f"blk{i}"]

    def dec(prm, tok, pos, jc):
        k, v = (jnp.asarray(port[n][0].float().numpy()).astype(jnp.bfloat16)
                for n in ("k", "v"))
        return step(prm, tok, pos, jc, k, v)

    return dec


def _close_bf16_cache(got, want):
    """A bf16 cache leaf against the reference's, for a model whose keys
    and values reach the cache through fp32 numbers that the two packages
    compute within fp32 noise but not bit for bit: QK-norm (XLA's rsqrt and
    mean round otherwise than torch's, so QK-norm moves the last fp32 bits
    of the keys, and through attention those of the later layers' values)
    and mamba2 blocks (fp32 recurrences and GEMMs whose sums the packages
    run in other orders, which feed zamba2-7b's shared attention block).
    Where such a number lies within that noise of a bf16
    rounding midpoint, the two packages store adjacent bf16 numbers
    (``tests/test_torch_bf16_cache_noise.py`` shows each such element of
    zamba2-7b's cache against an fp64 evaluation). Elements one bf16 step
    apart are allowed in under 1% of a leaf, every other element within TOL.
    The other models' bf16 cache leaves, and every fp32 one, are held to
    TOL everywhere."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    off = np.abs(g - w) > TOL
    step = np.abs(np.asarray(jnp.nextafter(jnp.asarray(want), jnp.asarray(np.inf, want.dtype))
                             .astype(jnp.float32)) - w)
    assert off.sum() < 0.01 * g.size, off.sum()
    np.testing.assert_array_less(np.abs(g - w)[off], 1.0001 * step[off] + 1e-30)


def test_decode_past_the_cache_end(model):
    """Decode at positions 0-5 into a 4-long cache: from position 4 on the
    reference's dynamic_update_slice clamps the write to the last slot, and
    valid_len = pos + 1 attends every slot."""
    jcfg, cfg, jp, p, _, dec = model
    opts = ModelOpts()
    toks = _tokens(cfg, 2, 6, seed=6)
    jc = jax_init_cache(jcfg, JaxOpts(remat=False), 2, 4, jnp.float32)
    c = init_cache(cfg, opts, 2, 4, torch.float32, device="cpu")
    jc = _fill_enc_out(cfg, jc, c, seed=6)
    for t in range(6):
        want, jc = dec(jp, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t), jc)
        got, c = forward_decode(cfg, opts, p,
                                {"token": torch.from_numpy(toks[:, t:t + 1]).long(),
                                 "pos": t}, c)
        _close(got, want)
        for g, w in zip(_leaves(c), _leaves(jc), strict=True):
            _close(g, w)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def test_decode_matches_prefill(model):
    """The port's token-by-token decode reproduces its full-sequence
    forward at the last position (the reference checks its own within 2e-3;
    the port's agree far closer). An encoder-decoder model's prefill takes
    random frames and its decode their encoding; a media prefix, which
    decode never sees, is left out."""
    _, cfg, _, p, _, _ = model
    opts = ModelOpts()
    toks = torch.from_numpy(_tokens(cfg, 1, 8, seed=2)).long()
    frames = {k: torch.from_numpy(v) for k, v in _stubs(cfg, 1, seed=2).items()
              if k == "frames"}
    full = forward_prefill(cfg, opts, p, {"tokens": toks, **frames})
    c = init_cache(cfg, opts, 1, 9, torch.float32, device="cpu")
    if cfg.enc_dec:
        c["enc_out"].copy_(_encode(cfg, opts, p, frames["frames"]))
    for t in range(8):
        logits, c = forward_decode(cfg, opts, p, {"token": toks[:, t:t + 1], "pos": t}, c)
    torch.testing.assert_close(logits, full, rtol=0, atol=TOL)


# --- modules ------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_reduced(jax_get_arch("llama3.2-3b"))
    jp = jax.tree.map(np.asarray, JA.init_attn(jax.random.PRNGKey(3), jcfg, jnp.float32))
    return jcfg, reduced(get_arch("llama3.2-3b")), jp, lm_from_jax(jp)


def test_attn_forward_prefill(llama):
    jcfg, cfg, jp, p = llama
    x = np.random.default_rng(3).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pos = np.arange(10)
    want, want_kv = JA.attn_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                    positions=jnp.asarray(pos), theta=cfg.rope_theta,
                                    return_kv=True)
    got, kv = A.attn_forward(cfg, p, torch.from_numpy(x), positions=torch.from_numpy(pos),
                             theta=cfg.rope_theta, return_kv=True)
    _close(got, want)
    _close(kv["k"], want_kv["k"])
    _close(kv["v"], want_kv["v"])


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_attn_forward_decode(llama, pos):
    jcfg, cfg, jp, p = llama
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    cache = {k: rng.standard_normal((2, 16, 2, 32)).astype(np.float32) for k in ("k", "v")}
    want, want_c = JA.attn_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                   positions=jnp.asarray([pos]), theta=cfg.rope_theta,
                                   cache=jax.tree.map(jnp.asarray, cache),
                                   cache_pos=jnp.asarray(pos))
    c = lm_from_jax(cache)
    got, c2 = A.attn_forward(cfg, p, torch.from_numpy(x), positions=torch.tensor([pos]),
                             theta=cfg.rope_theta, cache=c, cache_pos=pos)
    assert c2 is c
    _close(got, want)
    _close(c["k"], want_c["k"])
    _close(c["v"], want_c["v"])


def test_rwkv6_channel_mix():
    jcfg = jax_reduced(jax_get_arch("rwkv6-1.6b"))
    cfg = reduced(get_arch("rwkv6-1.6b"))
    rng = np.random.default_rng(4)
    jp = jax.tree.map(np.asarray, JS.init_rwkv6(jax.random.PRNGKey(4), jcfg, jnp.float32))
    for k in ("cm_mu_k", "cm_mu_r"):
        jp[k] = (rng.standard_normal(jp[k].shape) * 0.3).astype(np.float32)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    st = {"cm_x": rng.standard_normal((2, cfg.d_model)).astype(np.float32)}
    want, want_st = JS.rwkv6_channel_mix(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                         jax.tree.map(jnp.asarray, st))
    got, new = S.rwkv6_channel_mix(cfg, lm_from_jax(jp), torch.from_numpy(x), lm_from_jax(st))
    _close(got, want)
    _close(new["cm_x"], want_st["cm_x"], 0.0)


def test_rwkv6_state_layout():
    jcfg = jax_reduced(jax_get_arch("rwkv6-1.6b"))
    want = JS.init_rwkv6_state(jcfg, 3)
    got = S.init_rwkv6_state(reduced(get_arch("rwkv6-1.6b")), 3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 and not v.any() for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_run(arch):
    """The bf16 path (the card's default dtype) runs and stays finite on
    the CPU, with bf16 logits as the reference gives."""
    from dataclasses import replace

    cfg = replace(reduced(get_arch(arch)), param_dtype="bfloat16", compute_dtype="bfloat16")
    opts = ModelOpts()
    p = init_params(cfg, opts, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 6, seed=5)).long()
    stubs = {k: torch.from_numpy(v).bfloat16() for k, v in _stubs(cfg, 2, seed=5).items()}
    full = forward_prefill(cfg, opts, p, {"tokens": toks, **stubs})
    c = init_cache(cfg, opts, 2, 8, torch.bfloat16, device="cpu")
    if cfg.enc_dec:
        c["enc_out"].copy_(torch.from_numpy(_enc_out(cfg, 2, seed=5)))
    for t in range(6):
        logits, c = forward_decode(cfg, opts, p, {"token": toks[:, t:t + 1], "pos": t}, c)
    assert full.dtype == logits.dtype == torch.bfloat16
    assert torch.isfinite(full).all() and torch.isfinite(logits).all()
