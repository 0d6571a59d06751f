"""The port's RWKV6 recurrence as it runs on the CPU (the plain version,
``ref.rwkv6_scan_ref``, reached through ``ops.rwkv6_scan``) against the JAX
package's Pallas kernel in interpret mode, and the port's time-mix (which
runs the recurrence through ``ops.rwkv6_scan``) against the model's
``repro.models.ssm.rwkv6_time_mix``. All within 3e-5: fp32 sums in another
order, as the JAX kernel tests allow."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
from repro.models import ssm as JS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models import ssm as S


def _inputs(B, T, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    shp = (B, T, H, hd)
    r, k, v = ((rng.standard_normal(shp) * 0.3).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal(shp)))).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _close(got, want, tol=3e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("B,T,H,hd,chunk", [(2, 32, 4, 16, 8), (1, 40, 2, 32, 16),
                                            (3, 16, 1, 64, 4), (2, 13, 2, 32, 8)])
def test_scan_matches_pallas(B, T, H, hd, chunk):
    """T = 40 over chunks of 16 and T = 13 over chunks of 8 pad the Pallas
    kernel's time axis; the port takes any T unpadded."""
    ins = _inputs(B, T, H, hd)
    want_y, want_s = pallas_rwkv6(*(jnp.asarray(a) for a in ins), chunk=chunk)
    t = [torch.from_numpy(a) for a in ins]
    y, sT = ops.rwkv6_scan(*t)
    ry, rs = R.rwkv6_scan_ref(*t)
    assert torch.equal(y, ry) and torch.equal(sT, rs)  # the op's CPU path
    assert y.dtype == torch.float32 and y.shape == (B, T, H, hd)
    _close(y, want_y)
    _close(sT, want_s)


def test_scan_of_no_steps_keeps_the_state():
    ins = [torch.from_numpy(a) for a in _inputs(2, 0, 2, 16)]
    y, sT = ops.rwkv6_scan(*ins)
    assert y.shape == (2, 0, 2, 16) and torch.equal(sT, ins[-1])


@pytest.fixture(scope="module")
def block():
    """Reduced rwkv6-1.6b time-mix parameters on both sides, with the
    zero-initialised mixing, decay LoRA and bonus drawn at random so every
    term of the recurrence is exercised."""
    jcfg = jax_reduced(jax_get_arch("rwkv6-1.6b"))
    jp = jax.tree.map(np.asarray, JS.init_rwkv6(jax.random.PRNGKey(0), jcfg, jnp.float32))
    rng = np.random.default_rng(1)
    for k in ("mu_base", "mu", "lora_B", "decay_B", "u", "cm_mu_k", "cm_mu_r"):
        jp[k] = (rng.standard_normal(jp[k].shape) * 0.2).astype(np.float32)
    return jcfg, reduced(get_arch("rwkv6-1.6b")), jp, lm_from_jax(jp)


@pytest.mark.parametrize("T", [1, 13, 32])
def test_time_mix_matches_model(block, T):
    jcfg, cfg, jp, p = block
    rng = np.random.default_rng(T)
    x = (rng.standard_normal((2, T, cfg.d_model)) * 0.5).astype(np.float32)
    st = {"tm_x": (rng.standard_normal((2, cfg.d_model)) * 0.5).astype(np.float32),
          "cm_x": np.zeros((2, cfg.d_model), np.float32),
          "s": (rng.standard_normal((2, cfg.ssm_heads, 32, 32)) * 0.1).astype(np.float32)}
    want_y, want_st = JS.rwkv6_time_mix(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                        jax.tree.map(jnp.asarray, st))
    y, new = S.rwkv6_time_mix(cfg, p, torch.from_numpy(x), lm_from_jax(st))
    _close(y, want_y)
    _close(new["s"], want_st["s"])
    _close(new["tm_x"], want_st["tm_x"], 0.0)
