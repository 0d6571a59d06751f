"""flash_attention's tensor-core kernel (``csrc/flash_attention_sm90.cu``)
as far as the CPU can check it: which calls the wrapper sends to it, and a
plain-torch emulation of its arithmetic held to the JAX package's Pallas
kernel in interpret mode. Its head_dim 64 / 128 instances and its head_dim
256 instance (a TMA producer, warp-specialised) compute the same terms in
the same order, so one emulation holds all three.

The emulation repeats what the kernel does, in the kernel's order: bf16
inputs; per (batch, kv head) the flattened (query, q head) rows in blocks
of 128; keys in tiles of 64 from the first tile the block can see; S in
fp32 with the scale after the product; -1e30 where the masks exclude; the
online rescale by exp(m_old - m_new); P split into bf16 hi + lo for the
two P·V products, accumulated in fp32; acc / max(l, 1e-30) rounded once to
bf16. It lives here and is never on the port's path; on the card the
kernel itself is held to the plain version (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

BM, BN = 128, 64
BF16_ULP = 2.0**-7  # one bf16 ulp of x is at most 2^-7 |x|


def _emulate_sm90(q, k, v, *, causal=True, window=0, q_offset=0, split=True):
    """The kernel's arithmetic in fp32 (before the output's rounding)."""
    B, Sq, N, H = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = N // K
    out = torch.zeros((B, Sq, N, H), dtype=torch.float32)
    t_all = torch.arange(Sq * G)
    for b in range(B):
        for kvh in range(K):
            kf, vf = k[b, :, kvh].float(), v[b, :, kvh].float()
            for row0 in range(0, Sq * G, BM):
                t = t_all[row0:row0 + BM]
                qi, n = t // G, kvh * G + t % G
                qf = q[b, qi, n].float()
                qpos = q_offset + qi
                j_hi = min(Sk - 1, int(qpos[-1])) if causal else Sk - 1
                j_lo = max(0, int(qpos[0]) - window + 1) if window > 0 else 0
                m = torch.full((len(t),), -1e30)
                l = torch.zeros(len(t))
                acc = torch.zeros((len(t), H))
                for kt in range(j_lo // BN * BN, j_hi + 1, BN):
                    kp = torch.arange(kt, kt + BN)
                    ok = (kp < Sk)[None, :].expand(len(t), BN)
                    if causal:
                        ok = ok & (qpos[:, None] >= kp[None, :])
                    if window > 0:
                        ok = ok & (kp[None, :] > qpos[:, None] - window)
                    kk = torch.zeros((BN, H))
                    vv = torch.zeros((BN, H))
                    kk[:min(BN, Sk - kt)] = kf[kt:kt + BN]
                    vv[:min(BN, Sk - kt)] = vf[kt:kt + BN]
                    s = (qf @ kk.T) * H**-0.5
                    s = torch.where(ok, s, -1e30)
                    m_new = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    p_hi = p.bfloat16().float()
                    p_lo = (p - p_hi).bfloat16().float() if split else torch.zeros_like(p)
                    acc = acc * alpha[:, None] + (p_hi @ vv + p_lo @ vv)
                    m = m_new
                out[b, qi, n] = acc / torch.clamp_min(l, 1e-30)[:, None]
    return out


def _inputs(B, Sq, Sk, N, K, H, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
                 .bfloat16() for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H)))


def _pallas(q, k, v, dtype, **kw):
    out = pallas_flash(*(jnp.asarray(t.float().numpy()).astype(dtype) for t in (q, k, v)),
                       **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


# the kernel's edges, at most 150 queries and keys: Sq * G no multiple of
# 128; Sk no multiple of 64 with q_offset > 0; a window across tile edges;
# non-causal at G = 4; H = 64 at G = 1; then the same edges at H = 256 and
# G = 2 (gemma3-12b's head_dim and grouping; its local layers' window of
# 1024 over 4096 keys scaled down to 40 over 150); then H = 112 (zamba2-7b's
# shared attention block, whose rows the kernel stages in 128-wide tiles:
# the zero columns add nothing to S and nothing to O's first 112); then
# H = 64 non-causal as whisper-small's encoder and cross attention run it
# (12 heads, MHA): Sq * G and Sk both ragged, and Sq > Sk (the last key
# tile masked by k_len alone)
EDGES = [
    (1, 77, 77, 24, 8, 128, True, 0, 0),
    (2, 40, 100, 6, 2, 128, True, 0, 60),
    (1, 120, 120, 8, 2, 64, True, 70, 0),
    (1, 96, 128, 8, 2, 128, False, 0, 0),
    (2, 100, 100, 4, 4, 64, True, 0, 0),
    (1, 77, 77, 4, 2, 256, True, 0, 0),
    (1, 40, 100, 4, 2, 256, True, 0, 60),
    (1, 150, 150, 4, 2, 256, True, 40, 0),
    (1, 48, 100, 4, 2, 256, False, 0, 0),
    (1, 77, 77, 4, 4, 112, True, 0, 0),
    (1, 40, 100, 4, 2, 112, True, 0, 60),
    (1, 77, 100, 12, 12, 64, False, 0, 0),
    (1, 150, 36, 6, 2, 64, False, 0, 0),
]
IDS = ["rows_ragged", "keys_ragged_offset", "window", "noncausal_g4", "h64_g1",
       "h256_rows_ragged", "h256_keys_ragged_offset", "h256_window", "h256_noncausal",
       "h112_rows_ragged", "h112_keys_ragged_offset", "h64_noncausal_ragged",
       "h64_noncausal_sq_over_sk"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1, 2, 4096])
@pytest.mark.parametrize("H", [32, 64, 112, 128, 256])
def test_variant(dtype, Sq, H):
    if Sq == 1:
        want = "decode"
    else:
        want = "sm90" if dtype == torch.bfloat16 and H in (64, 112, 128, 256) else "tf32x3"
    assert FA._variant(dtype, Sq, H) == want


@pytest.mark.parametrize("B,Sq,Sk,N,K,H,causal,window,q_offset", EDGES, ids=IDS)
def test_emulation_matches_pallas_bf16(B, Sq, Sk, N, K, H, causal, window, q_offset):
    """Both round once to bf16 from fp32 results that differ by fp32 noise
    and P's lost low bits (at most 2^-18 of p): at most one bf16 ulp of each
    output element, 2^-7 |want| + 1e-6 (the bound chip_smoke.py holds the
    kernel to)."""
    q, k, v = _inputs(B, Sq, Sk, N, K, H)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_sm90(q, k, v, **kw).bfloat16().float()
    want = _pallas(q, k, v, jnp.bfloat16, **kw)
    assert ((got - want).abs() <= BF16_ULP * want.abs() + 1e-6).all()


@pytest.mark.parametrize("B,Sq,Sk,N,K,H,causal,window,q_offset", EDGES, ids=IDS)
def test_emulation_keeps_p_in_fp32(B, Sq, Sk, N, K, H, causal, window, q_offset):
    """Before the output's rounding, against the Pallas kernel in fp32 on
    the same (bf16-valued) inputs. P_hi + P_lo misses p by at most 2^-18 p,
    so an output, a p-weighted mean of v, moves by at most 2^-18 max|v|
    plus fp32 noise: within 2^-16 max|v| (3.4e-5 here; measured at most
    4.2e-6). P rounded once to bf16, as SDPA does, misses p by up to 2^-9 p
    and lands 3e-4 to 1.8e-3 away, outside that bound."""
    q, k, v = _inputs(B, Sq, Sk, N, K, H, seed=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _pallas(q, k, v, jnp.float32, **kw)
    bound = 2.0**-16 * v.float().abs().max()
    assert ((_emulate_sm90(q, k, v, **kw) - want).abs() <= bound).all()
    assert ((_emulate_sm90(q, k, v, split=False, **kw) - want).abs() > bound).any()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v = _inputs(1, 8, 8, 4, 2, 64)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert FA.variant_launches == {"sm90": 0, "tf32x3": 0, "decode": 0, "latent_decode": 0}
    assert ops.launches["flash_attention"] == 0


def test_cpu_h256_bf16_prefill_takes_the_plain_version_and_counts_nothing():
    """The call the H = 256 instance takes on a card (bf16 prefill, gemma3's
    G = 2, a window) computes the plain version on the CPU: equal to
    ``ref.flash_attention_ref`` bit for bit, and no launch counted."""
    from repro_torch.kernels import ref as R

    q, k, v = _inputs(1, 40, 40, 4, 2, 256)
    assert FA._variant(q.dtype, 40, 256) == "sm90"
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, window=16, q_offset=3)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.equal(out, R.flash_attention_ref(q, k, v, window=16, q_offset=3))
    assert FA.variant_launches == {"sm90": 0, "tf32x3": 0, "decode": 0, "latent_decode": 0}
    assert FA.sm90_launches == {(64, 64): 0, (128, 128): 0, (256, 256): 0, (192, 128): 0,
                                (112, 112): 0}
    assert ops.launches["flash_attention"] == 0


def test_reset_launches_zeroes_the_variant_counts():
    FA.variant_launches["sm90"] += 3
    FA.variant_launches["tf32x3"] += 1
    FA.variant_launches["latent_decode"] += 2
    FA.sm90_launches[(256, 256)] += 3
    FA.sm90_launches[(192, 128)] += 1
    FA.sm90_launches[(112, 112)] += 2
    ops.reset_launches()
    assert FA.variant_launches == {"sm90": 0, "tf32x3": 0, "decode": 0, "latent_decode": 0}
    assert FA.sm90_launches == {(64, 64): 0, (128, 128): 0, (256, 256): 0, (192, 128): 0,
                                (112, 112): 0}
