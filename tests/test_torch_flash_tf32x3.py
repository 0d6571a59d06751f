"""flash_attention's 3xTF32 kernel (``csrc/flash_attention.cu``) as far as
the CPU can check it: the TF32 split it runs on (``cvt.rna.tf32.f32``), and
a plain-torch emulation of its arithmetic held to the JAX package's Pallas
kernel in interpret mode.

The emulation repeats what the kernel does, in the kernel's order: q scaled
in fp32; per (batch, kv head) the flattened (query, q head) rows in blocks
of 128 (64 at head_dim 32 and 256); keys in tiles of 64 (32 at head_dim 32
and 256) from the first tile the block can see, zero-padded past Sk; S
accumulated in fp32 over 8-wide k-steps, each as lo·hi + hi·lo + hi·hi of
the TF32 splits (small terms first); -1e30 where the masks exclude; the
online rescale by exp(m_old - m_new); P·V over 8-key k-steps with P and V
split the same way; acc / max(l, 1e-30). bf16 inputs are exact in TF32, so their lo parts are 0
and the kernel skips those products; the emulation adds the zeros. A warp
that skips a tile its rows cannot see computes what the emulation computes
there (a wholly masked tile changes nothing once a row has seen a key, and
is wiped by the rescale before it has). It lives here and is never on the
port's path; on the card the kernel itself is held to the plain version
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R

FP32_TOL = 3e-5  # the JAX kernel tests' bound, and chip_smoke.py's
BF16_ULP = 2.0**-7  # one bf16 ulp of x is at most 2^-7 |x|


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped 13
    bits' range to the magnitude's bit pattern and clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def blocking(H: int) -> tuple[int, int]:
    """(rows a block, keys a tile) of the kernel's instance for head_dim H."""
    return (128, 64) if H in (64, 128) else (64, 32)


def _products(a, b, lo):
    """a @ b over 8-wide k-steps, each lo·hi + hi·lo + hi·hi of the TF32
    splits in that order (hi·hi alone when ``lo`` is False: plain TF32)."""
    out = torch.zeros((a.shape[0], b.shape[1]))
    for c in range(0, a.shape[1], 8):
        ah, al = split(a[:, c:c + 8])
        bh, bl = split(b[c:c + 8])
        if lo:
            out = out + al @ bh
            out = out + ah @ bl
        out = out + ah @ bh
    return out


def _emulate_tf32x3(q, k, v, *, causal=True, window=0, q_offset=0, lo=True):
    """The kernel's arithmetic in fp32 (before the output's rounding)."""
    B, Sq, N, H = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = N // K
    BM, BN = blocking(H)
    out = torch.zeros((B, Sq, N, H), dtype=torch.float32)
    t_all = torch.arange(Sq * G)
    for b in range(B):
        for kvh in range(K):
            kf, vf = k[b, :, kvh].float(), v[b, :, kvh].float()
            for row0 in range(0, Sq * G, BM):
                t = t_all[row0:row0 + BM]
                qi, n = t // G, kvh * G + t % G
                qf = q[b, qi, n].float() * H**-0.5
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
                    s = torch.where(ok, _products(qf, kk.T, lo), -1e30)
                    m_new = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + _products(p, vv, lo)
                    m = m_new
                out[b, qi, n] = acc / torch.clamp_min(l, 1e-30)[:, None]
    return out


def _inputs(B, Sq, Sk, N, K, H, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32)).to(dtype)
                 for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H)))


def _pallas(q, k, v, dtype, **kw):
    out = pallas_flash(*(jnp.asarray(t.float().numpy()).astype(dtype) for t in (q, k, v)),
                       **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


# the kernel's edges, at most 150 queries and 520 keys:
# (B, Sq, Sk, N, K, H, causal, window, q_offset, dtype)
EDGES = [
    (1, 77, 77, 24, 8, 128, True, 0, 0, torch.float32),  # Sq * G = 231 rows
    (2, 40, 100, 6, 2, 128, True, 0, 60, torch.float32),  # Sk % 64 != 0, q_offset
    (1, 120, 120, 8, 2, 64, True, 70, 0, torch.float32),  # a window across tiles
    (1, 96, 128, 8, 2, 128, False, 0, 0, torch.float32),  # non-causal, G = 4
    (2, 100, 100, 4, 4, 64, True, 0, 0, torch.float32),  # G = 1
    (2, 70, 70, 8, 2, 32, True, 0, 0, torch.float32),  # H 32: 64 rows, 32 keys
    (1, 77, 100, 4, 2, 256, True, 0, 23, torch.float32),  # H 256: 64 rows, 32 keys
    (1, 150, 150, 4, 2, 256, True, 40, 0, torch.float32),  # H 256, a window
    (2, 1, 300, 8, 8, 32, True, 0, 299, torch.float32),  # decode, G = 1
    (1, 1, 520, 16, 1, 64, True, 24, 400, torch.float32),  # decode, G = 16, window
    (2, 40, 100, 4, 2, 32, True, 24, 60, torch.bfloat16),  # bf16 at H 32
    (1, 77, 100, 4, 4, 112, True, 0, 23, torch.float32),  # H 112: 64 rows, 32 keys
]
IDS = ["rows_ragged", "keys_ragged_offset", "window", "noncausal_g4", "g1", "h32",
       "h256_ragged_offset", "h256_window", "decode_g1", "decode_g16_window", "bf16_h32",
       "h112_ragged_offset"]


def test_tf32_rna_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, -3.75, 1.2345678, 6.02e23, -1e-20, 0.0])
    hi = tf32_rna(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi - x).abs() <= 2.0**-11 * x.abs()).all()
    assert torch.equal(tf32_rna(hi), hi)


def test_tf32_rna_rounds_ties_away_from_zero():
    """A tie (dropped bits exactly 0x1000) rounds the magnitude up, both
    signs, where round-half-even would keep the even 0x3F800000; below the
    tie it rounds down, above it up."""
    bits = torch.tensor([0x3F801000, -0x407FF000, 0x3F800FFF, 0x3F801001, 0x3F803000],
                        dtype=torch.int32)  # -0x407FF000 is 0xBF801000
    want = torch.tensor([0x3F802000, -0x407FE000, 0x3F800000, 0x3F802000, 0x3F804000],
                        dtype=torch.int32)
    assert torch.equal(tf32_rna(bits.view(torch.float32)).view(torch.int32), want)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 7.5, 3e4])
def test_hi_plus_lo_reproduces_x(scale):
    """x - hi is exact in fp32, and lo rounds it to TF32: hi + lo misses x
    by at most 2^-22 |x| (half a TF32 ulp of a residual that is itself at
    most half a TF32 ulp of x)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32)) * scale
    hi, lo = split(x)
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi + lo - x).abs() <= 2.0**-22 * x.abs()).all()
    assert ((hi - x).abs() > 2.0**-22 * x.abs()).any()  # hi alone does not


def test_bf16_is_exact_in_tf32():
    """bf16's 8 mantissa bits fit TF32's 10: lo is 0, which is why the
    kernel skips K's and V's lo products for bf16 inputs."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(4096).astype(np.float32))
    x = x.bfloat16().float()
    hi, lo = split(x)
    assert torch.equal(hi, x) and not lo.any()


@pytest.mark.parametrize("B,Sq,Sk,N,K,H,causal,window,q_offset,dtype", EDGES, ids=IDS)
def test_emulation_matches_pallas_fp32(B, Sq, Sk, N, K, H, causal, window, q_offset, dtype):
    """Before any output rounding, against the Pallas kernel in fp32 on the
    same inputs (bf16-valued for the bf16 edge): within 3e-5, the bound the
    card's kernel is held to."""
    q, k, v = _inputs(B, Sq, Sk, N, K, H, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_tf32x3(q, k, v, **kw)
    want = _pallas(q, k, v, jnp.float32, **kw)
    assert (got - want).abs().max().item() <= FP32_TOL


def test_emulation_matches_pallas_bf16_at_h32():
    """bf16 at H 32, rounded once to bf16 as the kernel stores it, against
    the Pallas kernel in bf16: within one bf16 ulp of each element."""
    q, k, v = _inputs(2, 40, 100, 4, 2, 32, torch.bfloat16)
    kw = dict(causal=True, window=24, q_offset=60)
    got = _emulate_tf32x3(q, k, v, **kw).bfloat16().float()
    want = _pallas(q, k, v, jnp.bfloat16, **kw)
    assert ((got - want).abs() <= BF16_ULP * want.abs() + 1e-6).all()


def test_the_lo_terms_are_needed():
    """At the ragged-rows edge (seed 0), the same emulation with the lo
    terms dropped (1xTF32: hi·hi alone) misses the Pallas kernel by more
    than 3e-5 (q, k, p and v each lose up to 2^-11 of themselves), while
    3xTF32 stays within it."""
    q, k, v = _inputs(1, 77, 77, 24, 8, 128)
    want = _pallas(q, k, v, jnp.float32)
    err3 = (_emulate_tf32x3(q, k, v) - want).abs().max().item()
    err1 = (_emulate_tf32x3(q, k, v, lo=False) - want).abs().max().item()
    assert err3 <= FP32_TOL < err1


def test_cpu_fp32_prefill_takes_the_plain_version_and_counts_nothing():
    """The calls the 3xTF32 kernel takes on a card (fp32 prefill at any
    head_dim, bf16 prefill at H 32) compute the plain version on the CPU:
    equal to ``ref.flash_attention_ref`` bit for bit, and no launch
    counted."""
    ops.reset_launches()
    for dtype, H in ((torch.float32, 128), (torch.float32, 256), (torch.bfloat16, 32)):
        q, k, v = _inputs(1, 24, 24, 4, 2, H, dtype)
        assert FA._variant(dtype, 24, H) == "tf32x3"
        out = ops.flash_attention(q, k, v, window=8, q_offset=3)
        assert out.dtype == dtype and out.shape == q.shape
        assert torch.equal(out, R.flash_attention_ref(q, k, v, window=8, q_offset=3))
    assert FA.variant_launches == {"sm90": 0, "tf32x3": 0, "decode": 0, "latent_decode": 0}
    assert ops.launches["flash_attention"] == 0
