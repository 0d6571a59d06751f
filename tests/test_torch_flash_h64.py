"""flash_attention at head_dim 64 as whisper-small runs it (12 heads, MHA,
1500 encoder frames), as far as the CPU can check it: which kernel and
instance each call takes, the decode kernel's split plan at 12 kv heads,
causal (self-attention against the cache) and non-causal (cross attention
over the frames, where the query's position bounds nothing), and that a
non-causal call without a window has no row that sees no key, so the
wrapper launches no empty-row kernel there. The kernels' arithmetic at
these shapes is held to the Pallas kernel by the emulations of
``tests/test_torch_flash_sm90.py`` and ``tests/test_torch_flash_decode.py``
(their non-causal head_dim 64 cases), and on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R

H, K, FRAMES = 64, 12, 1500


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1, FRAMES, 4096])
def test_each_call_takes_its_instance_at_64(dtype, Sq):
    """Decode (one query, self or cross) on the decode kernel; the
    encoder's 1500 frames, the cross attention's and the decoder's 4096
    queries on the tensor-core kernel's (64, 64) instance in bf16, the
    3xTF32 kernel's in fp32."""
    variant = FA._variant(dtype, Sq, H)
    if Sq == 1:
        assert variant == "decode"
    else:
        assert variant == ("sm90" if dtype == torch.bfloat16 else "tf32x3")
    assert (H, H) in FA._instances(variant) and (H, H) in FA.sm90_launches


def _splits(plan, j_hi):
    j_lo, chunk, splits = plan
    return [range(j_lo + s * chunk, min(j_lo + (s + 1) * chunk, j_hi + 1))
            for s in range(splits)]


@pytest.mark.parametrize("q_offset", [0, 63, 4095, 9000])
def test_cross_attention_plan_ignores_the_query_position(q_offset):
    """8 requests x 12 kv heads over 1500 frames, non-causal: every frame
    visible whatever q_offset, in 6 splits of 256 keys, the last 220 long;
    the grid 8 x 12 x 6 = 576 blocks, at least DECODE_TARGET_BLOCKS."""
    plan = FA._decode_plan(8, K, FRAMES, q_offset, False, 0)
    assert plan == (0, 256, 6)
    parts = _splits(plan, FRAMES - 1)
    assert [len(r) for r in parts] == [256] * 5 + [220]
    assert [j for r in parts for j in r] == list(range(FRAMES))
    assert 8 * K * plan[2] >= FA.DECODE_TARGET_BLOCKS


@pytest.mark.parametrize("frames", [1, 200, 256])
def test_a_short_cross_range_runs_one_split(frames):
    """A range of up to DECODE_MIN_CHUNK keys runs one split: no merge pass."""
    assert FA._decode_plan(8, K, frames, 0, False, 0) == (0, 256, 1)


@pytest.mark.parametrize("q_offset", [0, 63, 255, 256, 4095])
def test_self_attention_plan_at_12_kv_heads(q_offset):
    """The decoder's causal self-attention against a 4096-long cache: the
    splits tile [0, q_offset] once, none empty; one split up to 256 keys;
    at 4095 six splits of 704 keys."""
    plan = FA._decode_plan(8, K, 4096, q_offset, True, 0)
    parts = _splits(plan, q_offset)
    assert [j for r in parts for j in r] == list(range(q_offset + 1))
    assert all(len(r) for r in parts)
    if q_offset < FA.DECODE_MIN_CHUNK:
        assert plan[2] == 1
    assert FA._decode_plan(8, K, 4096, 4095, True, 0) == (0, 704, 6)


@pytest.mark.parametrize("Sq,Sk,q_offset", [(1, FRAMES, 0), (1, FRAMES, 5000), (FRAMES, FRAMES, 0),
                                            (4096, FRAMES, 0), (77, 100, -50), (1, 1, 0)])
def test_no_empty_rows_without_a_mask(Sq, Sk, q_offset):
    """Non-causal without a window, every row sees every key: no empty-row
    launch, whatever the query offset or Sq > Sk. The same call causal at
    a negative offset has some."""
    assert not FA._has_empty_rows(Sq, Sk, q_offset, False, 0)
    if q_offset < 0:
        assert FA._has_empty_rows(Sq, Sk, q_offset, True, 0)


def test_cpu_calls_at_64_take_the_plain_version_and_count_nothing():
    """Non-causal calls on CPU tensors: the plain version, bit for bit, and
    no launch counted, the empty-row kernel's included."""
    ops.reset_launches()
    rng = np.random.default_rng(3)
    for Sq, Sk, dtype in ((1, 40, torch.float32), (1, 40, torch.bfloat16),
                          (50, 40, torch.float32), (50, 40, torch.bfloat16)):
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
                   for s in ((2, Sq, 6, H), (2, Sk, 6, H), (2, Sk, 6, H)))
        out = ops.flash_attention(q, k, v, causal=False, q_offset=0)
        assert out.dtype == dtype and out.shape == q.shape
        assert torch.equal(out, R.flash_attention_ref(q, k, v, causal=False))
    assert FA.variant_launches == {"sm90": 0, "tf32x3": 0, "decode": 0, "latent_decode": 0}
    assert ops.launches["flash_attention"] == 0
    assert _lib.launches["flash_attention_empty_rows"] == 0
