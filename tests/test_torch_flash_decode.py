"""flash_attention's split-KV decode kernel (``csrc/flash_attention_decode.cu``)
as far as the CPU can check it: the split plan the wrapper hands it, and a
plain-torch emulation of its split-and-merge arithmetic on that plan, held
to the JAX package's Pallas kernel in interpret mode and to its jnp ``mha``
with ``valid_len``.

The emulation repeats what the kernel does: q scaled by scale * log2 e in
fp32; per (batch, kv head, split) the scores of the split's keys, their
maximum m_s, l_s = sum 2^(s - m_s) and acc_s = sum 2^(s - m_s) v; then, in
split order, m* = max m_s, l = sum l_s 2^(m_s - m*) and o = sum acc_s
2^(m_s - m*) / max(l, 1e-30), rounded once to the output dtype; a query
that sees no key gets the mean of v, which the wrapper's empty-row kernel
(``csrc/flash_attention_empty_rows.cu``) writes after it. Inside a
split the kernel sums in another order (lane groups and warps merged at the
end), which moves results by fp32 noise only. It lives here and is never on
the port's path; on the card the kernel itself is held to the plain version
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.attention import mha as jax_mha
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as R

BF16_ULP = 2.0**-7  # one bf16 ulp of x is at most 2^-7 |x|
LOG2E = 1.0 / math.log(2.0)


def _range(k_len, q_offset, causal, window):
    j_hi = min(k_len - 1, q_offset) if causal else k_len - 1
    j_lo = max(0, q_offset - window + 1) if window > 0 else 0
    return j_lo, j_hi


@pytest.mark.parametrize("k_len", [33, 300, 4096])
@pytest.mark.parametrize("window", [0, 8, 24])
@pytest.mark.parametrize("q_offset", [0, 63, 4095, "past"])
def test_plan_covers_the_range_once(k_len, window, q_offset):
    """Splits tile [j_lo, j_hi] exactly, none of them empty, for a batch of
    8 against 8 kv heads and for one sequence against one."""
    qo = k_len + 5 if q_offset == "past" else q_offset
    for B, K in ((8, 8), (1, 1)):
        j_lo, j_hi = _range(k_len, qo, True, window)
        lo, chunk, splits = FA._decode_plan(B, K, k_len, qo, True, window)
        assert lo == j_lo
        if j_hi < j_lo:
            assert splits == 0
            continue
        keys = []
        for s in range(splits):
            split = range(j_lo + s * chunk, min(j_lo + (s + 1) * chunk, j_hi + 1))
            assert len(split) > 0
            keys.extend(split)
        assert keys == list(range(j_lo, j_hi + 1))


def test_plan_fills_the_card_and_keeps_short_ranges_whole():
    """A full 4096-long cache at 8 x 8 (batch, kv head) runs 8 splits of 512
    keys, 512 blocks; position 63 (64 keys) runs one split, so no merge."""
    assert FA._decode_plan(8, 8, 4096, 4095, True, 0) == (0, 512, 8)
    assert FA._decode_plan(8, 8, 4096, 63, True, 0) == (0, 256, 1)
    assert FA._decode_plan(1, 1, 131072, 131071, True, 0)[2] == 512


def _emulate_decode(q, k, v, *, causal=True, window=0, q_offset=0):
    """The kernel's arithmetic in fp32, on the wrapper's plan."""
    B, _, N, H = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = N // K
    j_lo, chunk, splits = FA._decode_plan(B, K, Sk, q_offset, causal, window)
    _, j_hi = _range(Sk, q_offset, causal, window)
    qs = q[:, 0].float() * (H**-0.5 * LOG2E)  # (B, N, H)
    out = torch.zeros((B, 1, N, H))
    for b in range(B):
        for kvh in range(K):
            rows = slice(kvh * G, (kvh + 1) * G)
            ms, ls, accs = [], [], []
            for s in range(splits):
                keys = slice(j_lo + s * chunk, min(j_lo + (s + 1) * chunk, j_hi + 1))
                kf, vf = k[b, keys, kvh].float(), v[b, keys, kvh].float()
                sc = qs[b, rows] @ kf.T  # (G, keys)
                m = sc.max(-1).values
                p = torch.exp2(sc - m[:, None])
                ms.append(m)
                ls.append(p.sum(-1))
                accs.append(p @ vf)
            m_star = torch.full((G,), -1e30)
            for m in ms:
                m_star = torch.maximum(m_star, m)
            l, acc = torch.zeros(G), torch.zeros((G, H))
            for m, ls_, a in zip(ms, ls, accs):
                f = torch.exp2(m - m_star)
                l = l + ls_ * f
                acc = acc + a * f[:, None]
            out[b, 0, rows] = acc / torch.clamp_min(l, 1e-30)[:, None]
            if FA._has_empty_rows(1, Sk, q_offset, causal, window):
                # the empty-row kernel the wrapper launches after this one
                out[b, 0, rows] = v[b, :, kvh].float().sum(0) / Sk
    return out


def _inputs(B, Sk, N, K, H, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
                 for s in ((B, 1, N, H), (B, Sk, K, H), (B, Sk, K, H)))


def _pallas(q, k, v, dtype, **kw):
    out = pallas_flash(*(jnp.asarray(t.float().numpy()).astype(dtype) for t in (q, k, v)),
                       block_k=64, **kw)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


# (B, Sk, N, K, H, causal, window, q_offset): G in {1, 3, 4, 8, 16}, every
# head_dim, ranges of several splits whose last is short (k_len no multiple
# of the chunk), windows inside one split and across splits, a query past
# the cache's end (every slot visible), non-causal (and as whisper-small's
# cross attention runs it: 12 heads, MHA, over 1500 frames in 6 splits, the
# last 220 keys, and over 200 in one)
CASES = [
    (2, 300, 8, 8, 32, True, 0, 299),
    (2, 700, 6, 2, 64, True, 0, 650),
    (1, 1000, 4, 1, 128, True, 100, 900),
    (1, 1500, 16, 2, 256, True, 0, 1499),
    (1, 600, 24, 8, 128, True, 0, 700),
    (1, 1200, 8, 2, 128, True, 700, 1100),
    (2, 300, 4, 2, 32, False, 0, 5),
    (1, 520, 16, 1, 64, True, 24, 400),
    (1, 520, 16, 1, 64, True, 0, 519),
    (1, 700, 4, 2, 112, True, 0, 650),
    (2, 1500, 12, 12, 64, False, 0, 0),
    (2, 200, 12, 12, 64, False, 0, 0),
]
IDS = ["g1_h32_2splits", "g3_h64_3splits", "g4_h128_window", "g8_h256_6splits",
       "g3_past_the_end", "window_across_splits", "noncausal", "g16_window", "g16_3splits",
       "g2_h112_3splits", "g1_h64_noncausal_6splits", "g1_h64_noncausal_1split"]


@pytest.mark.parametrize("B,Sk,N,K,H,causal,window,q_offset", CASES, ids=IDS)
def test_emulation_matches_pallas_fp32(B, Sk, N, K, H, causal, window, q_offset):
    q, k, v = _inputs(B, Sk, N, K, H)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_decode(q, k, v, **kw)
    assert ((got - _pallas(q, k, v, jnp.float32, **kw)).abs() <= 3e-5).all()


@pytest.mark.parametrize("B,Sk,N,K,H,causal,window,q_offset", CASES, ids=IDS)
def test_emulation_matches_pallas_bf16(B, Sk, N, K, H, causal, window, q_offset):
    """Both compute in fp32 from the same bf16 inputs and round once: at
    most one bf16 ulp of each output element, 2^-7 |want| + 1e-6."""
    q, k, v = (t.bfloat16() for t in _inputs(B, Sk, N, K, H, seed=1))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _emulate_decode(q, k, v, **kw).bfloat16().float()
    want = _pallas(q, k, v, jnp.bfloat16, **kw)
    assert ((got - want).abs() <= BF16_ULP * want.abs() + 1e-6).all()


@pytest.mark.parametrize("B,Sk,N,K,H,causal,window,q_offset", CASES, ids=IDS)
def test_emulation_matches_mha_valid_len(B, Sk, N, K, H, causal, window, q_offset):
    """The model's decode attention: the causal mask as valid_len =
    q_offset + 1 over the cache's positions."""
    q, k, v = _inputs(B, Sk, N, K, H, seed=2)
    want = jax_mha(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                   q_positions=jnp.asarray([q_offset]), k_positions=jnp.arange(Sk),
                   causal=causal, window=window,
                   valid_len=q_offset + 1 if causal else None)
    got = _emulate_decode(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert ((got - torch.from_numpy(np.array(want))).abs() <= 3e-5).all()


def test_no_visible_key_averages_v_as_the_oracle_though_pallas_writes_zero():
    """ROADMAP C8: a window that ends before the cache does (qpos - window +
    1 > k_len - 1) leaves no visible key. The numerics oracle
    (``flash_attention_ref``, the port's plain version) and the jnp ``mha``
    average every v there (a softmax over equal -1e30 scores), and the port
    follows them: the plan has no split, and the wrapper's empty-row kernel
    writes the mean of v. The Pallas kernel, which reaches no kv block,
    writes 0: the reference's odd one out, recorded here."""
    q, k, v = _inputs(2, 33, 6, 2, 64, seed=3)
    kw = dict(causal=True, window=8, q_offset=100)
    assert FA._decode_plan(2, 2, 33, 100, True, 8)[2] == 0
    assert FA._has_empty_rows(1, 33, 100, True, 8)
    got = _emulate_decode(q, k, v, **kw)
    oracle = R.flash_attention_ref(q, k, v, **kw)
    assert (got - oracle).abs().max() <= 3e-5
    want = jax_mha(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                   q_positions=jnp.asarray([100]), k_positions=jnp.arange(33), window=8)
    assert (got - torch.from_numpy(np.array(want))).abs().max() <= 3e-5
    assert torch.equal(_pallas(q, k, v, jnp.float32, **kw), torch.zeros_like(q))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 8])
@pytest.mark.parametrize("Sq,Sk,q_offset", [(1, 33, 100), (1, 33, 39), (1, 33, 40),
                                             (16, 16, 0), (64, 64, 40), (8, 20, -3),
                                             (4, 10, 30)])
def test_empty_rows_found_from_ints(causal, window, Sq, Sk, q_offset):
    """``_has_empty_rows`` (which checks the first and the last row) against
    each row's range, and the plain version's output on such rows against
    the mean of v."""
    rows = [i for i in range(Sq)
            if _range(Sk, q_offset + i, causal, window)[0] >
            _range(Sk, q_offset + i, causal, window)[1]]
    assert FA._has_empty_rows(Sq, Sk, q_offset, causal, window) == bool(rows)
    if rows:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, Sq, 4, 8), (1, Sk, 2, 8), (1, Sk, 2, 8)))
        o = R.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
        mean = v[0].mean(0).repeat_interleave(2, dim=0)  # (N, H)
        assert (o[0, rows] - mean).abs().max() <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [32, 64, 112, 128, 256])
def test_every_decode_call_takes_the_decode_kernel(dtype, H):
    assert FA._variant(dtype, 1, H) == "decode"
    assert FA._variant(dtype, 2, H) != "decode"
