"""GQA flash attention (causal / sliding-window), forward only: the wrapper
around three CUDA kernels for the one TPU kernel, and around MLA's
latent-attention decode kernel, which replaces no TPU kernel.

Counterpart of ``repro.kernels.flash_attention``. q (B, Sq, N, H), k (B,
Sk, K, H) and v (B, Sk, K, Hv) with N % K == 0; q head n reads kv head n //
(N / K). Hv is H but for MLA's expanded prefill (deepseek-v2-lite-16b: q
and k 192 wide, 128 nope + 64 rope, v 128); the scale is H^-0.5 of q's
head_dim, as the reference's ``mha`` takes it. Masks use absolute
positions: query i sits at ``q_offset + i``; causal keeps keys at or
before it, ``window > 0`` keeps the trailing ``window`` keys. The softmax
runs online in fp32; the output (B, Sq, N, Hv) has q's dtype.

``causal``, ``window`` and ``q_offset`` are runtime arguments of the kernel
(the TPU kernel takes them as static only because of jit), so a decode loop
passes its position as a plain int with no recompilation and no read-back.
On a CUDA tensor the wrapper launches the kernel ``_variant`` picks, or
raises (it never retries on another kernel); on a CPU tensor it computes
the plain version in ``ref.py``:

- ``"decode"``, ``repro_torch/csrc/flash_attention_decode.cu``: every call
  with Sq = 1, fp32 or bf16, any head_dim in ``HEAD_DIMS`` with Hv = H
  (at 112 a key row is spread over a power-of-two group of lanes, some of
  them idle);
  The kv range is split across blocks by ``_decode_plan`` and the partial
  softmax states are merged;
- ``"sm90"``, ``repro_torch/csrc/flash_attention_sm90.cu``: bf16 prefill
  (Sq > 1) at (H, Hv) in ``SM90_INSTANCES``, both products on the tensor
  cores (wgmma); (256, 256) (gemma3-12b's) runs an instance of its own,
  with a TMA producer warpgroup, and (192, 128) (deepseek-v2-lite-16b's
  MLA prefill) and (112, 112) (zamba2-7b's shared attention block)
  instances of the (64, 64) / (128, 128) kernel, with Q and K 192 wide,
  or with rows of 112 staged in 128-wide tiles whose last 16 columns are
  zeros;
- ``"tf32x3"``, ``repro_torch/csrc/flash_attention.cu``: the rest of
  prefill (fp32 at every (H, Hv) of ``TF32X3_INSTANCES``, bf16 at head_dim
  32), both products on the tensor cores as 3xTF32 (each operand split
  into a TF32 high part and a TF32 residual, three mma.sync products
  accumulated in fp32), which keeps fp32's accuracy.

Any other (H, Hv) pair raises on a CUDA tensor: no call is padded to
another instance.

``latent_decode`` is MLA's absorbed decode (``"latent_decode"``,
``repro_torch/csrc/flash_attention_latent_decode.cu``): one fp32 query a
sequence and head against the compressed cache, whose rows are both the
keys (c_kv joined to k_rope, 576 wide) and, in their first 512 columns,
the values. The reference computes it in jnp einsums
(``repro.models.attention.mla_forward``); the kernel reads c_kv and k_rope
where they lie (two pointers, each with its row stride), so the cache is
never copied, cast or joined. Both products run on the tensor cores with
fp32's accuracy: on a bf16 cache (the serving path) wgmma, the cache
staged by TMA in its own dtype and q and p split into three bf16 parts;
on an fp32 cache mma.sync with every operand split into TF32 hi and lo.
``_latent_plan`` spreads a call over splits of the key range and, at
short ranges, groups of value columns.

A query row whose visible key range is empty (a window that ends before
the keys do, ROADMAP C8) gets the mean of v over all Sk keys, as the plain
version and the reference's jnp ``mha`` give (a softmax over Sk equal
masked scores); the Pallas kernel writes 0 there. ``_has_empty_rows``
finds such calls from ints alone, and the wrapper then launches
``csrc/flash_attention_empty_rows.cu`` after the picked kernel, which
overwrites those rows.

On a ``meta`` tensor (``launch.dryrun``'s trace) each wrapper allocates
its output and the kernel's scratch (the decode kernel's split partials,
the latent decode's split pass) on ``meta`` and reports the kernel's FLOPs
(``attention_flops``, ``latent_decode_flops``: the unmasked pairs the
kernel computes; the counts ``chip_smoke.py``'s bounds use) through
``_lib.meta_launch``; nothing is computed or counted.

The kernels have no backward (nor has the TPU kernel): on a CUDA tensor the
wrapper raises if grad mode is on and an input requires grad, rather than
return an output with no ``grad_fn``.

``_lib.launches["flash_attention"]`` counts the calls that launch a kernel
(``latent_decode``'s included), ``variant_launches`` counts them per
variant, ``sm90_launches`` the ``"sm90"`` ones per (H, Hv) instance, and
``_lib.launches["flash_attention_empty_rows"]`` the launches of the
empty-row kernel. ``sm90_attrs`` and ``tf32x3_attrs`` read an instance's
registers and local (spill) bytes from the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R

HEAD_DIMS = (32, 64, 112, 128, 256)  # the decode kernel's, H = Hv
# (H, Hv) instances: q and k's head_dim, v's
SM90_INSTANCES = ((64, 64), (128, 128), (256, 256), (192, 128), (112, 112))
TF32X3_INSTANCES = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128), (112, 112))
DTYPES = (torch.float32, torch.bfloat16)
# the latent decode kernel's one instance: deepseek-v2-lite-16b's cache rows
# (kv_lora_rank 512 + qk_rope_dim 64), of which the first 512 are v, and
# its 16 heads at most
LATENT_DIMS = (512, 64)
LATENT_MAX_HEADS = 16

variant_launches = _lib.counter(("sm90", "tf32x3", "decode", "latent_decode"))
sm90_launches = _lib.counter(SM90_INSTANCES)

# the decode kernel's split plan: fill the card's 132 SMs about four times
# over with (batch, kv head, split) blocks, but give no split fewer than
# DECODE_MIN_CHUNK keys, so a short range runs one split and no merge pass;
# chunks are a multiple of the kernel's keys per block step at head_dim 128
# (32 or 64), so only a range's last split ends in a partial step
SMS = 132
DECODE_TARGET_BLOCKS = 4 * SMS
DECODE_MIN_CHUNK = 256
DECODE_CHUNK_ALIGN = 64


def _variant(dtype: torch.dtype, Sq: int, H: int, Hv: int | None = None) -> str:
    """Which kernel a CUDA call runs: the split-KV decode kernel for one
    query, the bf16 tensor-core kernel for bf16 prefill at an (H, Hv) of
    ``SM90_INSTANCES``, the 3xTF32 kernel for the rest."""
    if Sq == 1:
        return "decode"
    if dtype == torch.bfloat16 and (H, H if Hv is None else Hv) in SM90_INSTANCES:
        return "sm90"
    return "tf32x3"


def _instances(variant: str) -> tuple[tuple[int, int], ...]:
    """The (H, Hv) pairs a variant's kernel is compiled for."""
    if variant == "decode":
        return tuple((h, h) for h in HEAD_DIMS)
    return SM90_INSTANCES if variant == "sm90" else TF32X3_INSTANCES


def _decode_plan(B: int, K: int, k_len: int, q_offset: int, causal: bool,
                 window: int) -> tuple[int, int, int]:
    """(j_lo, chunk, splits) for one query at ``q_offset``: its visible keys
    are [j_lo, j_hi], and split s takes [j_lo + s chunk, j_lo + (s + 1)
    chunk) of them. No split is empty; splits is 0 when the range is."""
    j_hi = min(k_len - 1, q_offset) if causal else k_len - 1
    j_lo = max(0, q_offset - window + 1) if window > 0 else 0
    n = j_hi - j_lo + 1
    if n <= 0:
        return j_lo, 0, 0
    want = -(-DECODE_TARGET_BLOCKS // max(1, B * K))
    chunk = max(DECODE_MIN_CHUNK, -(-n // want))
    chunk = -(-chunk // DECODE_CHUNK_ALIGN) * DECODE_CHUNK_ALIGN
    return j_lo, chunk, -(-n // chunk)


# the latent decode kernel's plan: splits of a multiple of LATENT_TILE keys
# (an iteration of its bf16 kernel, wgmma's M of 64; the fp32 kernel's tiles
# are 32); one block an SM (215 KB of shared memory), so the grid stays
# within one wave of SMS blocks. Splits of the key range come first, at most
# LATENT_MAX_SPLITS: each writes 16 x 514 fp32 partials (32.9 KB) that the
# merge pass reads back, and at 16 splits of a full 4096-row bf16 sequence
# (4.7 MB) that traffic is 0.53 MB each way. What is left of the wave goes
# to value-column groups (1, 2 or 4 blocks share a split's 512 columns, each
# recomputing S from rows that L2 holds), so serving's short ranges fill
# the card too
LATENT_TILE = 64
LATENT_MAX_SPLITS = 16
LATENT_MAX_VSPLITS = 4


def _latent_plan(B: int, S: int, q_offset: int) -> tuple[int, int, int]:
    """(chunk, splits, vsplits) of the latent decode kernel for B sequences
    at ``q_offset`` against an S-row cache: its visible keys are [0,
    min(q_offset, S - 1)], split s takes [s chunk, (s + 1) chunk) of them
    (chunk a multiple of LATENT_TILE, no split empty), and vsplits blocks
    share each split's value columns. The grid is B x splits x vsplits
    blocks, at most SMS when B <= SMS. At B = 8: 16 splits of 256 keys at
    a full cache, 1 x 4 and 2 x 4 (splits x vsplits) at 1-64 and 65-128
    keys."""
    n = min(q_offset, S - 1) + 1
    want = max(1, min(LATENT_MAX_SPLITS, SMS // max(1, B)))
    per = -(-n // want)
    chunk = -(-per // LATENT_TILE) * LATENT_TILE
    splits = -(-n // chunk)
    vsplits = 1
    while vsplits < LATENT_MAX_VSPLITS and 2 * B * splits * vsplits <= SMS:
        vsplits *= 2
    return chunk, splits, vsplits


def attention_pairs(Sq: int, Sk: int, q_offset: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of a call: each query's visible key
    range [j_lo, j_hi] as the kernels' masks leave it, the window
    included."""
    qpos = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    j_hi = np.minimum(qpos, Sk - 1) if causal else np.full_like(qpos, Sk - 1)
    j_lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    return int(np.maximum(0, j_hi - j_lo + 1).sum())


def attention_flops(B: int, Sq: int, Sk: int, N: int, H: int, Hv: int, causal: bool,
                    window: int, q_offset: int) -> float:
    """The kernel's FLOPs: 2 (H + Hv) a (query, key) pair and head that the
    mask leaves (q·k and p·v, an FMA as two)."""
    return 2.0 * (H + Hv) * B * N * attention_pairs(Sq, Sk, q_offset, causal, window)


def latent_decode_flops(B: int, N: int, S: int, L: int, Rd: int, q_offset: int) -> float:
    """The latent decode kernel's FLOPs: 2 (L + Rd + L) a key and head over
    the keys at or before ``q_offset`` (the scores over c_kv joined to
    k_rope, then p·c_kv)."""
    return 2.0 * (L + Rd + L) * B * N * (min(int(q_offset), S - 1) + 1)


def _has_empty_rows(Sq: int, Sk: int, q_offset: int, causal: bool, window: int) -> bool:
    """Whether a query row at q_offset + i, i < Sq, sees no key. The rows
    that see some key are those with qpos >= 0 (causal) and qpos <= Sk +
    window - 2 (window > 0): one interval, so an empty row exists iff the
    first or the last row is empty."""
    def empty(qpos):
        j_hi = min(Sk - 1, qpos) if causal else Sk - 1
        j_lo = max(0, qpos - window + 1) if window > 0 else 0
        return j_lo > j_hi

    return Sq > 0 and (empty(q_offset) or empty(q_offset + Sq - 1))


def _attrs(entry: str, *args: int) -> tuple[int, int]:
    """(registers a thread, local bytes a thread) that C entry ``entry``
    reads with ``cudaFuncGetAttributes`` for the instance ``args`` name.
    Local bytes are spills and stack."""
    a = _lib.kernel_attrs(entry, *args)
    return a["regs"], a["local_bytes"]


def sm90_attrs(H: int, Hv: int) -> tuple[int, int]:
    """(registers, local bytes) a thread of the ``"sm90"`` kernel instance
    (H, Hv), on the card; the kernels are written for no local bytes."""
    return _attrs("flash_attention_sm90_attrs", H, Hv)


def tf32x3_attrs(H: int, Hv: int, dtype: torch.dtype) -> tuple[int, int]:
    """(registers, local bytes) a thread of the ``"tf32x3"`` kernel
    instance (H, Hv) for dtype, on the card."""
    return _attrs("flash_attention_attrs", H, Hv, int(dtype == torch.bfloat16))


def latent_decode_attrs(dtype: torch.dtype) -> tuple[int, int]:
    """(registers, local bytes) a thread of the latent decode kernel's split
    pass for a cache of ``dtype`` (for bf16 the instance of one value-column
    group, the serving path's at a full cache), on the card."""
    return _attrs("flash_attention_latent_decode_attrs", int(dtype != torch.bfloat16), 4)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"flash_attention: want q (B, Sq, N, H), k (B, Sk, K, H) and v (B, Sk, K, Hv); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, N, H = q.shape
    if k.shape[0] != B or k.shape[3] != H or N % k.shape[2]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)} "
            "(batch and head_dim must match, N % K == 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q, k, v must share one of {DTYPES}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must share a device")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Returns (B, Sq, N, Hv) in q's dtype."""
    _check(q, k, v)
    if not (q.is_cuda or q.is_meta):
        return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    _lib.refuse_grad("flash_attention", q, k, v)
    B, Sq, N, H = q.shape
    Sk, K, Hv = k.shape[1], k.shape[2], v.shape[3]
    variant = _variant(q.dtype, Sq, H, Hv)
    if (H, Hv) not in _instances(variant):
        raise ValueError(f"flash_attention: the {variant} kernel takes (head_dim, v's "
                         f"head_dim) in {_instances(variant)}, got {(H, Hv)}")
    _lib.check_cuda("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes 16-byte aligned tensors")
    out = q.new_empty((B, Sq, N, Hv))
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    mask = (int(bool(causal)), int(window), int(q_offset), Sk, float(H**-0.5))
    flops = lambda: attention_flops(B, Sq, Sk, N, H, Hv, bool(causal), int(window),  # noqa: E731
                                    int(q_offset))
    if variant == "decode":
        _, chunk, splits = _decode_plan(B, K, Sk, int(q_offset), bool(causal), int(window))
        ws = torch.empty(B * N * splits * (H + 2) if splits > 1 else 0,
                         dtype=torch.float32, device=q.device)
        _lib.launch("flash_attention_decode", q.device, *ptrs, ws.data_ptr(), B, Sk, N, K,
                    H, int(q.dtype == torch.bfloat16), *mask, chunk, splits,
                    count_as="flash_attention", flops=flops, scratch=(ws,))
    elif variant == "sm90":
        _lib.launch("flash_attention_sm90", q.device, *ptrs, B, Sq, Sk, N, K, H, Hv, *mask,
                    count_as="flash_attention", flops=flops)
    else:
        _lib.launch("flash_attention", q.device, *ptrs, B, Sq, Sk, N, K, H, Hv,
                    int(q.dtype == torch.bfloat16), *mask, flops=flops)
    if not q.is_meta:
        variant_launches[variant] += 1
        if variant == "sm90":
            sm90_launches[(H, Hv)] += 1
    if _has_empty_rows(Sq, Sk, int(q_offset), bool(causal), int(window)):
        _lib.launch("flash_attention_empty_rows", q.device, v.data_ptr(), out.data_ptr(), B,
                    Sq, Sk, N, K, Hv, int(q.dtype == torch.bfloat16), int(bool(causal)),
                    int(window), int(q_offset))
    return out


def _check_latent(q, c_kv, k_rope):
    if q.dim() != 4 or q.shape[1] != 1 or c_kv.dim() != 3 or k_rope.dim() != 3:
        raise ValueError(
            f"latent_decode: want q (B, 1, N, L + R), c_kv (B, S, L), k_rope (B, S, R); got "
            f"{tuple(q.shape)}, {tuple(c_kv.shape)}, {tuple(k_rope.shape)}")
    B, _, _, D = q.shape
    if (c_kv.shape[0] != B or k_rope.shape[:2] != c_kv.shape[:2]
            or D != c_kv.shape[2] + k_rope.shape[2]):
        raise ValueError(
            f"latent_decode: q {tuple(q.shape)} does not fit c_kv {tuple(c_kv.shape)} and "
            f"k_rope {tuple(k_rope.shape)}")
    if q.dtype != torch.float32 or c_kv.dtype not in DTYPES or k_rope.dtype != c_kv.dtype:
        raise TypeError(
            f"latent_decode: q must be fp32 and the cache one of {DTYPES}; got {q.dtype}, "
            f"{c_kv.dtype}, {k_rope.dtype}")
    if not (q.device == c_kv.device == k_rope.device):
        raise ValueError("latent_decode: q and the cache must share a device")


def latent_decode(q, c_kv, k_rope, *, scale: float, q_offset: int):
    """MLA's absorbed decode, one query a sequence at position ``q_offset``:
    q (B, 1, N, L + R) fp32, the cache's c_kv (B, S, L) and k_rope (B, S,
    R) in bf16 or fp32, each with unit stride along its last axis and any
    row stride (views of one (B, S, L + R) buffer, or two buffers). Returns
    ctx (B, 1, N, L) fp32 = softmax_j(scale q . [c_kv, k_rope][j]) c_kv[j]
    over j <= q_offset (``ref.latent_decode_ref``). On the card one launch
    of the kernel on ``_latent_plan``'s grid, and of its merge pass when
    the plan has more than one split."""
    _check_latent(q, c_kv, k_rope)
    if not (q.is_cuda or q.is_meta):
        return R.latent_decode_ref(q, c_kv, k_rope, scale=scale, q_offset=q_offset)
    _lib.refuse_grad("latent_decode", q, c_kv, k_rope)
    B, _, N, _ = q.shape
    S, L, Rd = c_kv.shape[1], c_kv.shape[2], k_rope.shape[2]
    if (L, Rd) != LATENT_DIMS or not 1 <= N <= LATENT_MAX_HEADS:
        raise ValueError(f"latent_decode: the kernel takes (L, R) = {LATENT_DIMS} and at most "
                         f"{LATENT_MAX_HEADS} heads, got {(L, Rd)} and {N}")
    if int(q_offset) < 0 or S < 1:
        raise ValueError(f"latent_decode: needs q_offset >= 0 and a cache row, got "
                         f"q_offset {q_offset} and {S} rows")
    _lib.check_cuda("latent_decode", q)
    if q.data_ptr() % 16:
        raise ValueError("latent_decode: the kernel takes a 16-byte aligned q")
    size = c_kv.element_size()
    for name, t in (("c_kv", c_kv), ("k_rope", k_rope)):
        if t.device != q.device or t.stride(2) != 1 or (t.stride(1) * size) % 16 or \
                (t.stride(0) * size) % 16 or t.data_ptr() % 16:
            raise ValueError(f"latent_decode: {name} needs unit stride along its last axis "
                             "and 16-byte aligned rows")
    out = q.new_empty((B, 1, N, L))
    if out.numel() == 0:
        return out
    chunk, splits, vsplits = _latent_plan(B, S, int(q_offset))
    ws = torch.empty(B * N * splits * (L + 2) if splits > 1 else 0, dtype=torch.float32,
                     device=q.device)
    _lib.launch("flash_attention_latent_decode", q.device, q.data_ptr(), c_kv.data_ptr(),
                k_rope.data_ptr(), out.data_ptr(), ws.data_ptr(), B, S, N,
                c_kv.stride(0), c_kv.stride(1), k_rope.stride(0), k_rope.stride(1),
                int(c_kv.dtype == torch.bfloat16), int(q_offset), float(scale), chunk, splits,
                vsplits, count_as="flash_attention", scratch=(ws,),
                flops=lambda: latent_decode_flops(B, N, S, L, Rd, q_offset))
    if not q.is_meta:
        variant_launches["latent_decode"] += 1
    return out
