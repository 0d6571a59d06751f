"""RWKV6 ("Finch") time-mix recurrence: the wrapper around two CUDA
forward kernels for the one TPU kernel, and a CUDA backward kernel.

Counterpart of ``repro.kernels.rwkv6_scan``. Per batch row and head, with
the fp32 hd x hd state S starting at s0:

    y_t = r_t · (S + diag(u) k_t v_tᵀ),    S ← diag(w_t) S + k_t v_tᵀ.

r, k, v, w (B, T, H, hd) are cast to fp32, as the reference does; u (H, hd)
and s0 (B, H, hd, hd) too. Returns y (B, T, H, hd) and the final state
(B, H, hd, hd), both fp32. Any T, with no padding. On a CUDA tensor the
wrapper launches the kernel ``_variant(T)`` picks, or raises (it never
retries on the other kernel); on a CPU tensor it computes the plain version
in ``ref.py``:

- ``"seq"``, ``repro_torch/csrc/rwkv6_scan.cu``: T <= ``SEQ_MAX_T`` (decode
  steps), one block per (b, h) stepping through time;
- ``"chunked"``, ``repro_torch/csrc/rwkv6_scan_chunked.cu``: longer T
  (prefill), the time axis cut into chunks of ``CHUNK`` steps run in
  parallel from a zero state and joined by a scan over the chunks' end
  states (``ref.rwkv6_scan_chunked_ref`` is the same algorithm in torch).

When grad mode is on and an input requires grad, the call goes through
``Rwkv6Scan``, a ``torch.autograd.Function``: its forward is the call
above, and its backward launches ``repro_torch/csrc/rwkv6_scan_bwd.cu`` on
the card (the chunked matrix form, its products on the tensor cores as
3xTF32: states at chunks of ``_bwd_chunk(hd)`` steps, decayed parts at
sub-chunks of ``BWD_SUB``; ``ref.rwkv6_scan_grad_chunked_ref`` is the same
algorithm in torch) or runs ``ref.rwkv6_scan_grad_ref`` on the CPU. The
TPU kernel has no backward: the reference trains through XLA's
gradient of its ``lax.scan``, which both compute. The backward keeps only
the inputs from the forward and recomputes the states it needs, so a call
under ``torch.no_grad()`` (serving) allocates and launches what it did
before the backward existed.

On a ``meta`` tensor (``launch.dryrun``'s trace) the wrapper takes the
CUDA path's allocations on ``meta`` (the fp32 copies, the outputs, the
chunked scan's and the backward's chunk scratch) and reports the kernels'
FLOPs (``scan_flops``, ``scan_grad_flops``) through ``_lib.meta_launch``;
nothing is computed or counted.

``_lib.launches["rwkv6_scan"]`` counts the calls that launch a forward
kernel, ``variant_launches`` counts them per variant, and
``_lib.launches["rwkv6_scan_bwd"]`` the backward's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R

HEAD_DIMS = (16, 32, 64, 128)
CHUNK = 64  # steps per chunk of the chunked kernel
SEQ_MAX_T = 16  # the longest T the sequential kernel takes (at most CHUNK)
BWD_CHUNK = 64  # steps per chunk of the backward kernel's states (a multiple of BWD_SUB)
BWD_SUB = 16  # steps per sub-chunk of its decayed parts: fixed in the kernel (kSubChunk)

variant_launches = _lib.counter(("seq", "chunked"))


def _variant(T: int) -> str:
    """Which kernel a CUDA call runs: the sequential one for short T (a
    decode step), the chunked scan for the rest."""
    return "seq" if T <= SEQ_MAX_T else "chunked"


def _bwd_chunk(hd: int) -> int:
    """Steps per chunk of the backward kernel at head_dim ``hd``: at 128
    only one sub-chunk a chunk fits shared memory, and the kernel takes no
    other length there."""
    return BWD_SUB if hd == 128 else BWD_CHUNK


def bwd_smem(hd: int, chunk: int) -> int:
    """Bytes of shared memory a block of the backward kernel needs at
    head_dim ``hd`` and chunks of ``chunk`` steps (the card's opt-in limit
    bounds the chunk)."""
    need = ctypes.c_longlong(0)
    err = _lib.lib().rwkv6_scan_bwd_smem(hd, chunk, ctypes.byref(need))
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd_smem({hd}, {chunk}) failed: cudaError {err}")
    return need.value


def scan_flops(B: int, T: int, H: int, hd: int) -> float:
    """The forward's FLOPs: 5 hd^2 + 5 hd a token and head (an FMA as
    two: y's reads of the state and of u k v^T, the state's update)."""
    return float((5 * hd * hd + 5 * hd) * T * H * B)


def scan_grad_flops(B: int, T: int, H: int, hd: int) -> float:
    """The backward's FLOPs: 14 hd^2 + 12 hd a token and head (the states
    recomputed, dr, dk, dv, dw, du and the state's gradient)."""
    return float((14 * hd * hd + 12 * hd) * T * H * B)


def _aligned(*tensors):
    """The kernels stage their arrays with 16-byte accesses: a view that
    starts off that grid is copied to a fresh allocation."""
    return (t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _forward(r, k, v, w, u, s0):
    """y, sT by the plain version (a CPU tensor) or the kernel ``_variant``
    picks (fp32 contiguous CUDA tensors)."""
    if not (r.is_cuda or r.is_meta):
        return R.rwkv6_scan_ref(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    y = torch.empty_like(r)
    sT = torch.empty_like(s0)
    variant = _variant(T)
    flops = lambda: scan_flops(B, T, H, hd)  # noqa: E731
    if variant == "seq":
        _lib.launch("rwkv6_scan", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                    w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
                    B, T, H, hd, flops=flops)
    else:
        r, k, v, w = _aligned(r, k, v, w)
        nc = -(-T // CHUNK)
        st = torch.empty((B, H, nc, hd, hd), dtype=torch.float32, device=r.device)
        rp = torch.empty_like(r)
        pend = torch.empty((B, H, nc, hd), dtype=torch.float32, device=r.device)
        _lib.launch("rwkv6_scan_chunked", r.device, r.data_ptr(), k.data_ptr(),
                    v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                    sT.data_ptr(), st.data_ptr(), rp.data_ptr(), pend.data_ptr(), B, T, H,
                    hd, CHUNK, count_as="rwkv6_scan", flops=flops, scratch=(st, rp, pend))
    if not r.is_meta:
        variant_launches[variant] += 1
    return y, sT


def _backward(r, k, v, w, u, s0, dy, dsT):
    """(dr, dk, dv, dw, du, ds0): the plain backward on a CPU tensor, the
    backward kernel on fp32 contiguous CUDA tensors (du summed from its
    per-chunk partials)."""
    if not (r.is_cuda or r.is_meta):
        return R.rwkv6_scan_grad_ref(r, k, v, w, u, s0, dy, dsT)
    B, T, H, hd = r.shape
    dy, dsT = dy.contiguous(), dsT.contiguous()  # fp32, as y and sT are
    _lib.check_cuda("rwkv6_scan_bwd", r, dy, dsT)
    r, k, v, w, dy = _aligned(r, k, v, w, dy)
    chunk = _bwd_chunk(hd)
    nc = -(-T // chunk)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    ds0 = torch.empty_like(s0)
    dup = torch.empty((B, H, nc, hd), dtype=torch.float32, device=r.device)
    sx = torch.empty((B, H, nc, hd, hd), dtype=torch.float32, device=r.device)
    gx = torch.empty_like(sx)
    pend = torch.empty_like(dup)
    _lib.launch("rwkv6_scan_bwd", r.device,
                *(t.data_ptr() for t in (r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, dup,
                                          ds0, sx, gx, pend)),
                B, T, H, hd, chunk, flops=lambda: scan_grad_flops(B, T, H, hd),
                scratch=(dup, sx, gx, pend))
    return dr, dk, dv, dw, dup.sum((0, 2)), ds0


class Rwkv6Scan(torch.autograd.Function):
    """``rwkv6_scan`` with a gradient: the forward of ``_forward``, the
    backward of ``_backward``, on the inputs saved from the forward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _forward(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, dsT):
        grads = _backward(*ctx.saved_tensors, dy, dsT)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def rwkv6_scan(r, k, v, w, u, s0):
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(
            f"rwkv6_scan: want r, k, v, w (B, T, H, hd); got {tuple(r.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}")
    B, T, H, hd = r.shape
    if u.shape != (H, hd) or s0.shape != (B, H, hd, hd):
        raise ValueError(
            f"rwkv6_scan: want u ({H}, {hd}) and s0 ({B}, {H}, {hd}, {hd}); got "
            f"{tuple(u.shape)}, {tuple(s0.shape)}")
    if not all(t.is_floating_point() for t in (r, k, v, w, u, s0)):
        raise TypeError("rwkv6_scan: inputs must be floating point")
    if len({t.device for t in (r, k, v, w, u, s0)}) != 1:
        raise ValueError("rwkv6_scan: inputs must share a device")
    ins = (r, k, v, w, u, s0)
    if r.is_cuda or r.is_meta:
        if hd not in HEAD_DIMS:
            raise ValueError(f"rwkv6_scan: the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
        ins = tuple(t.to(torch.float32) for t in ins)
        _lib.check_cuda("rwkv6_scan", *ins)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return Rwkv6Scan.apply(*ins)
    return _forward(*ins)
