"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same numpy inputs, within 1e-6
(fp32; both sides round the same operations, in orders that may differ)."""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import layers as J
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.models import layers as L

TOL = 1e-6
RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 5, 64)).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    scale = RNG.standard_normal(64).astype(np.float32) * 0.1
    want = J.rmsnorm(jnp.asarray(X).astype(dtype), jnp.asarray(scale))
    got = L.rmsnorm(torch.from_numpy(X).to(getattr(torch, dtype)), torch.from_numpy(scale))
    assert got.dtype == getattr(torch, dtype)
    # bf16: both sides round the same fp32 values to the same bf16
    _close(got, np.asarray(want.astype(jnp.float32)), TOL if dtype == "float32" else 0.0)


def test_layernorm():
    scale = 1 + RNG.standard_normal(64).astype(np.float32) * 0.1
    bias = RNG.standard_normal(64).astype(np.float32) * 0.1
    want = J.layernorm(jnp.asarray(X), jnp.asarray(scale), jnp.asarray(bias))
    got = L.layernorm(*(torch.from_numpy(a) for a in (X, scale, bias)))
    _close(got, want)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b"])
def test_init_and_apply_norm(arch):
    cfg, jcfg = reduced(get_arch(arch)), jax_reduced(jax_get_arch(arch))
    jp = J.init_norm(jcfg, 64)
    p = L.init_norm(cfg, 64)
    assert p.keys() == jp.keys()
    for k in p:
        assert p[k].dtype == torch.float32
        _close(p[k], jp[k], 0.0)
    _close(L.apply_norm(cfg, p, torch.from_numpy(X)), J.apply_norm(jcfg, jp, jnp.asarray(X)))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    pos = np.arange(12)
    js, jc = J.rope_angles(jnp.asarray(pos), 32, theta)
    s, c = L.rope_angles(torch.from_numpy(pos), 32, theta)
    _close(s, js)
    _close(c, jc)
    x = RNG.standard_normal((2, 12, 3, 32)).astype(np.float32)
    _close(L.apply_rope(torch.from_numpy(x), s, c), J.apply_rope(jnp.asarray(x), js, jc))


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "sq_relu", "gelu"])
def test_mlp(act):
    import jax

    jcfg = replace(jax_reduced(jax_get_arch("llama3.2-3b")), mlp_act=act)
    cfg = replace(reduced(get_arch("llama3.2-3b")), mlp_act=act)
    jp = J.init_mlp(jax.random.PRNGKey(0), jcfg, 64, 96, jnp.float32)
    p = L.init_mlp(torch.Generator().manual_seed(0), cfg, 64, 96, torch.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    p = lm_from_jax({k: np.asarray(v) for k, v in jp.items()})
    _close(L.apply_mlp(cfg, p, torch.from_numpy(X)), J.apply_mlp(jcfg, jp, jnp.asarray(X)))


def test_dense_and_embed_init():
    """Another generator than jax.random, so the draws differ; the law is
    the reference's: a normal truncated to [-2, 2] times the scale."""
    g = torch.Generator().manual_seed(0)
    w = L.dense_init(g, 256, 512, torch.float32)
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert w.abs().max() <= 2.0 * 256**-0.5 + 1e-7
    # std of N(0, 1) truncated to [-2, 2]: 0.8796
    assert abs(w.std().item() / 256**-0.5 - 0.8796) < 0.01
    assert torch.equal(w, L.dense_init(torch.Generator().manual_seed(0), 256, 512,
                                       torch.float32))
    e = L.embed_init(g, 300, 64, torch.bfloat16)
    assert e.dtype == torch.bfloat16 and e.float().abs().max() <= 0.04 * (1 + 2**-8)
    w2 = L.dense_init(g, 64, 32, torch.float32, scale=0.5)
    assert w2.abs().max() <= 1.0


@pytest.mark.parametrize("vocab", [512, 500, 128256, 65536, 1])
def test_padded_vocab(vocab):
    assert L.padded_vocab(vocab) == J.padded_vocab(vocab)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_padded_logits(dtype):
    z = RNG.standard_normal((3, 512)).astype(np.float32)
    want = J.mask_padded_logits(jnp.asarray(z).astype(dtype), 500)
    got = L.mask_padded_logits(torch.from_numpy(z).to(getattr(torch, dtype)), 500)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    same = L.mask_padded_logits(torch.from_numpy(z), 512)
    assert torch.equal(same, torch.from_numpy(z))


def test_mm_promotes_like_jnp():
    a = torch.from_numpy(X[0])
    b = torch.from_numpy(RNG.standard_normal((64, 8)).astype(np.float32)).bfloat16()
    got = L.mm(a, b)
    want = jnp.asarray(X[0]) @ jnp.asarray(b.float().numpy()).astype(jnp.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, 1e-5)
