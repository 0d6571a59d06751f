"""flash_attention at head_dim 112 (zamba2-7b's shared attention block, 32
heads, MHA) as far as the CPU can check it: which kernel and instance each
call takes, the decode kernel's split plan at 32 kv heads, and its lane map.

The decode kernel (``csrc/flash_attention_decode.cu``) reads a key row with
a group of lanes, one 16-byte load each, and sums the lanes' partial dot
products with xor shuffles inside the group; the groups then merge their
softmax states with xor shuffles across groups. Both need the group's
lane count to be a power of two that divides 32. At 112 a row is 14 loads
in bf16 and 28 in fp32, so the kernel gives it 16 and 32 lanes, the last
2 and 4 idle (they hold zeros). A numpy emulation of the warp's shuffles
shows that map gives every key's dot product exactly as a plain sum does,
and that 14 lanes a row would mix two keys' partial sums. On the card the
kernel itself is held to the plain version (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R

H = 112


def _pow2_ceil(n):
    return 1 << (n - 1).bit_length()


def _lane_dots(q, keys, lpk, units):
    """The warp's scores for the keys its lane groups hold: lane l of group
    g (l < lpk) holds 16-byte unit l of key g's row when l < units, else
    zeros; each lane's partial dot product with q, then the kernel's
    butterfly, ``sc += shfl_xor(sc, off)`` for off = lpk / 2, ..., 1 over
    all 32 lanes. Returns each group's lane-0 sum (the kernel reads any
    lane of a group: they end equal)."""
    ve = H // units  # elements a load
    part = np.zeros(32)
    for lane in range(32):
        g, l = divmod(lane, lpk)
        if g < len(keys) and l < units:
            cols = slice(l * ve, (l + 1) * ve)
            part[lane] = q[cols] @ keys[g][cols]
    off = lpk // 2
    while off > 0:
        part = part + part[np.arange(32) ^ off]
        off //= 2
    return [part[g * lpk] for g in range(len(keys))]


@pytest.mark.parametrize("units", [14, 28], ids=["bf16", "fp32"])
def test_the_lane_map_gives_every_key_its_dot_product(units):
    rng = np.random.default_rng(units)
    lpk = _pow2_ceil(units)
    assert lpk in (16, 32) and 32 % lpk == 0
    q = rng.standard_normal(H)
    keys = [rng.standard_normal(H) for _ in range(32 // lpk)]
    got = _lane_dots(q, keys, lpk, units)
    np.testing.assert_allclose(got, [q @ k for k in keys], rtol=1e-12)


def test_fourteen_lanes_a_row_would_mix_two_keys():
    """The old layout's LPK = H / 8 = 14 lanes (bf16): the xor offsets 7,
    3, 1 pair lanes across the 14-lane groups' edges, so the sums are
    wrong."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal(H)
    keys = [rng.standard_normal(H) for _ in range(2)]
    got = _lane_dots(q, keys, 14, 14)
    assert not np.allclose(got, [q @ k for k in keys], rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_call_takes_its_instance_at_112(dtype):
    assert FA._variant(dtype, 1, H) == "decode"
    assert (H, H) in FA._instances("decode")
    variant = FA._variant(dtype, 4096, H)
    assert variant == ("sm90" if dtype == torch.bfloat16 else "tf32x3")
    assert (H, H) in FA._instances(variant) and (H, H) in FA._instances("tf32x3")
    assert H in FA.HEAD_DIMS and (H, H) in FA.sm90_launches


@pytest.mark.parametrize("q_offset", [0, 63, 100, 4095, 5000])
def test_decode_plan_at_32_kv_heads(q_offset):
    """zamba2-7b's decode step, 8 requests x 32 kv heads against a
    4096-long cache: the splits tile the visible range once, none empty;
    the grid covers at least DECODE_TARGET_BLOCKS blocks where the range
    has enough keys, and a range of up to 256 keys runs one split (no
    merge pass)."""
    j_hi = min(4095, q_offset)
    j_lo, chunk, splits = FA._decode_plan(8, 32, 4096, q_offset, True, 0)
    assert j_lo == 0 and chunk % FA.DECODE_CHUNK_ALIGN == 0
    keys = [j for s in range(splits) for j in range(s * chunk, min((s + 1) * chunk, j_hi + 1))]
    assert keys == list(range(j_hi + 1))
    assert (splits - 1) * chunk <= j_hi  # no empty split
    if j_hi + 1 <= FA.DECODE_MIN_CHUNK:
        assert splits == 1
    else:
        assert 8 * 32 * splits >= FA.DECODE_TARGET_BLOCKS
    assert FA._decode_plan(8, 32, 4096, 4095, True, 0) == (0, 1408, 3)


def test_cpu_calls_at_112_take_the_plain_version_and_count_nothing():
    ops.reset_launches()
    rng = np.random.default_rng(1)
    for Sq, dtype in ((1, torch.float32), (1, torch.bfloat16), (9, torch.float32),
                      (9, torch.bfloat16)):
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
                   for s in ((2, Sq, 4, H), (2, 12, 4, H), (2, 12, 4, H)))
        out = ops.flash_attention(q, k, v, q_offset=12 - Sq)
        assert out.dtype == dtype and out.shape == q.shape
        assert torch.equal(out, R.flash_attention_ref(q, k, v, q_offset=12 - Sq))
    assert FA.variant_launches == {"sm90": 0, "tf32x3": 0, "decode": 0, "latent_decode": 0}
    assert ops.launches["flash_attention"] == 0 and sum(FA.sm90_launches.values()) == 0
