"""The port's flash attention as it runs on the CPU (its plain version,
``ref.flash_attention_ref``, reached through ``ops.flash_attention``)
against the JAX package's Pallas kernel in interpret mode and against the
model's jnp attention ``repro.models.attention.mha``.

Tolerances are the JAX kernel tests' own: 3e-5 in fp32 (sums in another
order), 2e-2 in bf16 (output rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.attention import mha as jax_mha
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R


def _inputs(B, Sq, Sk, N, K, H, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(s) * 0.5).astype(np.float32)
                 for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H)))


def _port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    out = ops.flash_attention(*t, **kw)
    assert torch.equal(out, R.flash_attention_ref(*t, **kw))  # the op's CPU path
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               rtol=0, atol=tol)


@pytest.mark.parametrize(
    "B,Sq,Sk,N,K,H,causal,window",
    [
        (2, 32, 32, 4, 2, 32, True, 0),
        (1, 64, 64, 8, 8, 64, True, 0),
        (2, 32, 32, 4, 1, 32, True, 8),
        (1, 16, 64, 4, 2, 32, True, 0),  # short q against a longer kv
        (2, 24, 24, 2, 2, 128, False, 0),
        (1, 20, 40, 4, 2, 32, True, 12),  # kv length no tile multiple, a window
    ],
)
def test_matches_pallas(B, Sq, Sk, N, K, H, causal, window):
    q, k, v = _inputs(B, Sq, Sk, N, K, H)
    qo = Sk - Sq if causal else 0
    want = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window,
                        q_offset=qo, block_q=16, block_k=16)
    _close(_port(q, k, v, causal=causal, window=window, q_offset=qo), want, 3e-5)


@pytest.mark.parametrize("q_offset", [0, 5, 31])
def test_q_offset_matches_pallas(q_offset):
    """Queries at absolute positions q_offset.., against 48 cached keys."""
    q, k, v = _inputs(2, 8, 48, 4, 2, 32, seed=1)
    want = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), q_offset=q_offset,
                        block_q=16, block_k=16)
    _close(_port(q, k, v, q_offset=q_offset), want, 3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_matches_pallas(dtype):
    q, k, v = _inputs(1, 32, 32, 4, 2, 64, seed=2)
    want = pallas_flash(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                        block_q=16, block_k=16)
    got = _port(q, k, v, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want.astype(jnp.float32), 2e-2 if dtype == "bfloat16" else 3e-5)


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("window", [0, 8])
def test_matches_model_mha(chunk, window):
    """The model's own attention, dense and chunked."""
    q, k, v = _inputs(2, 64, 64, 4, 2, 32, seed=3)
    pos = np.arange(64)
    want = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray(pos),
                   k_positions=jnp.asarray(pos), causal=True, window=window, chunk=chunk)
    _close(_port(q, k, v, window=window), want, 3e-5)


@pytest.mark.parametrize("pos", [0, 9, 23])
def test_decode_matches_mha_valid_len(pos):
    """Decode: one query at ``pos`` against a 24-long cache. The model masks
    with valid_len = pos + 1; the kernel's causal mask at q_offset = pos is
    the same mask."""
    q, k, v = _inputs(3, 1, 24, 6, 2, 32, seed=4)
    kpos = np.arange(24)
    want = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), q_positions=jnp.asarray([pos]),
                   k_positions=jnp.asarray(kpos), causal=True, valid_len=pos + 1)
    _close(_port(q, k, v, q_offset=pos), want, 3e-5)


def test_bf16_decode_matches_pallas():
    q, k, v = _inputs(2, 1, 40, 6, 2, 128, seed=5)
    want = pallas_flash(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                        q_offset=17, block_q=16, block_k=16)
    _close(_port(q, k, v, torch.bfloat16, q_offset=17), want.astype(jnp.float32), 2e-2)


def test_wrapper_checks_shapes_and_types():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 3, 2, 32))
    with pytest.raises(ValueError):  # N % K != 0
        ops.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 4, 2, 32))
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v[:, :3])
