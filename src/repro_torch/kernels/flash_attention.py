"""GQA flash attention (causal / sliding-window), forward only: the wrapper
around three CUDA kernels for the one TPU kernel.

Counterpart of ``repro.kernels.flash_attention``. q (B, Sq, N, H), k and v
(B, Sk, K, H) with N % K == 0; q head n reads kv head n // (N / K). Masks
use absolute positions: query i sits at ``q_offset + i``; causal keeps
keys at or before it, ``window > 0`` keeps the trailing ``window`` keys.
The softmax runs online in fp32; the output has q's dtype.

``causal``, ``window`` and ``q_offset`` are runtime arguments of the kernel
(the TPU kernel takes them as static only because of jit), so a decode loop
passes its position as a plain int with no recompilation and no read-back.
On a CUDA tensor the wrapper launches the kernel ``_variant`` picks, or
raises (it never retries on another kernel); on a CPU tensor it computes
the plain version in ``ref.py``:

- ``"decode"``, ``repro_torch/csrc/flash_attention_decode.cu``: every call
  with Sq = 1, fp32 or bf16, any head_dim. The kv range is split across
  blocks by ``_decode_plan`` and the partial softmax states are merged;
- ``"sm90"``, ``repro_torch/csrc/flash_attention_sm90.cu``: bf16 prefill
  (Sq > 1) at head_dim 64, 128 or 256, both products on the tensor cores
  (wgmma); head_dim 256 (gemma3-12b's) runs an instance of its own, with a
  TMA producer warpgroup;
- ``"tf32x3"``, ``repro_torch/csrc/flash_attention.cu``: the rest of
  prefill (fp32 at every head_dim, bf16 at head_dim 32), both products on
  the tensor cores as 3xTF32 (each operand split into a TF32 high part and
  a TF32 residual, three mma.sync products accumulated in fp32), which
  keeps fp32's accuracy.

A query row whose visible key range is empty (a window that ends before
the keys do, ROADMAP C8) gets the mean of v over all Sk keys, as the plain
version and the reference's jnp ``mha`` give (a softmax over Sk equal
masked scores); the Pallas kernel writes 0 there. ``_has_empty_rows``
finds such calls from ints alone, and the wrapper then launches
``csrc/flash_attention_empty_rows.cu`` after the picked kernel, which
overwrites those rows.

The kernels have no backward (nor has the TPU kernel): on a CUDA tensor the
wrapper raises if grad mode is on and an input requires grad, rather than
return an output with no ``grad_fn``.

``_lib.launches["flash_attention"]`` counts the calls that launch a kernel,
``variant_launches`` counts them per variant, ``sm90_launches`` the
``"sm90"`` ones per head_dim (each head_dim is a kernel instance of its
own), and ``_lib.launches["flash_attention_empty_rows"]`` the launches of
the empty-row kernel. ``sm90_attrs`` and ``tf32x3_attrs`` read an
instance's registers and local (spill) bytes from the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R

HEAD_DIMS = (32, 64, 128, 256)
SM90_HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

variant_launches = _lib.counter(("sm90", "tf32x3", "decode"))
sm90_launches = _lib.counter(SM90_HEAD_DIMS)

# the decode kernel's split plan: fill the card's 132 SMs about four times
# over with (batch, kv head, split) blocks, but give no split fewer than
# DECODE_MIN_CHUNK keys, so a short range runs one split and no merge pass;
# chunks are a multiple of the kernel's keys per block step at head_dim 128
# (32 or 64), so only a range's last split ends in a partial step
SMS = 132
DECODE_TARGET_BLOCKS = 4 * SMS
DECODE_MIN_CHUNK = 256
DECODE_CHUNK_ALIGN = 64


def _variant(dtype: torch.dtype, Sq: int, H: int) -> str:
    """Which kernel a CUDA call runs: the split-KV decode kernel for one
    query, the bf16 tensor-core kernel for bf16 prefill at head_dim 64,
    128 or 256, the 3xTF32 kernel for the rest."""
    if Sq == 1:
        return "decode"
    if dtype == torch.bfloat16 and H in SM90_HEAD_DIMS:
        return "sm90"
    return "tf32x3"


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
    regs, local = ctypes.c_int(0), ctypes.c_longlong(0)
    err = getattr(_lib.lib(), entry)(*args, ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"{entry}{args} failed: cudaError {err}")
    return regs.value, local.value


def sm90_attrs(H: int) -> tuple[int, int]:
    """(registers, local bytes) a thread of the ``"sm90"`` kernel instance
    for head_dim H, on the card; the kernels are written for no local
    bytes."""
    return _attrs("flash_attention_sm90_attrs", H)


def tf32x3_attrs(H: int, dtype: torch.dtype) -> tuple[int, int]:
    """(registers, local bytes) a thread of the ``"tf32x3"`` kernel
    instance for head_dim H and dtype, on the card."""
    return _attrs("flash_attention_attrs", H, int(dtype == torch.bfloat16))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: want q (B, Sq, N, H), k and v (B, Sk, K, H); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, N, H = q.shape
    if k.shape[0] != B or k.shape[3] != H or N % k.shape[2]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)} "
            "(batch and head_dim must match, N % K == 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q, k, v must share one of {DTYPES}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must share a device")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Returns (B, Sq, N, H) in q's dtype."""
    _check(q, k, v)
    if not q.is_cuda:
        return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    _lib.refuse_grad("flash_attention", q, k, v)
    B, Sq, N, H = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if H not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head_dim in {HEAD_DIMS}, got {H}")
    _lib.check_cuda("flash_attention", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes 16-byte aligned tensors")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    mask = (int(bool(causal)), int(window), int(q_offset), Sk, float(H**-0.5))
    variant = _variant(q.dtype, Sq, H)
    if variant == "decode":
        _, chunk, splits = _decode_plan(B, K, Sk, int(q_offset), bool(causal), int(window))
        ws = torch.empty(B * N * splits * (H + 2) if splits > 1 else 0,
                         dtype=torch.float32, device=q.device)
        _lib.launch("flash_attention_decode", q.device, *ptrs, ws.data_ptr(), B, Sk, N, K,
                    H, int(q.dtype == torch.bfloat16), *mask, chunk, splits,
                    count_as="flash_attention")
    elif variant == "sm90":
        _lib.launch("flash_attention_sm90", q.device, *ptrs, B, Sq, Sk, N, K, H, *mask,
                    count_as="flash_attention")
        sm90_launches[H] += 1
    else:
        _lib.launch("flash_attention", q.device, *ptrs, B, Sq, Sk, N, K, H,
                    int(q.dtype == torch.bfloat16), *mask)
    variant_launches[variant] += 1
    if _has_empty_rows(Sq, Sk, int(q_offset), bool(causal), int(window)):
        _lib.launch("flash_attention_empty_rows", q.device, v.data_ptr(), out.data_ptr(), B,
                    Sq, Sk, N, K, H, int(q.dtype == torch.bfloat16), int(bool(causal)),
                    int(window), int(q_offset))
    return out
