"""RWKV6 ("Finch") time-mix recurrence, forward only: the wrapper around the
CUDA kernel in ``repro_torch/csrc/rwkv6_scan.cu``.

Counterpart of ``repro.kernels.rwkv6_scan``. Per batch row and head, with
the fp32 hd x hd state S starting at s0:

    y_t = r_t · (S + diag(u) k_t v_tᵀ),    S ← diag(w_t) S + k_t v_tᵀ.

r, k, v, w (B, T, H, hd) are cast to fp32, as the reference does; u (H, hd)
and s0 (B, H, hd, hd) too. Returns y (B, T, H, hd) and the final state
(B, H, hd, hd), both fp32. Any T, with no padding. On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it computes the plain
version in ``ref.py``. The kernel has no backward (nor has the TPU kernel),
so on a CUDA tensor the wrapper raises if grad mode is on and an input
requires grad, rather than return outputs with no ``grad_fn``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R

HEAD_DIMS = (16, 32, 64, 128)


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
    if not r.is_cuda:
        return R.rwkv6_scan_ref(r, k, v, w, u, s0)
    _lib.refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    r, k, v, w, u, s0 = (t.to(torch.float32) for t in (r, k, v, w, u, s0))
    _lib.check_cuda("rwkv6_scan", r, k, v, w, u, s0)
    y = torch.empty_like(r)
    sT = torch.empty_like(s0)
    _lib.launch("rwkv6_scan", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
                B, T, H, hd)
    return y, sT
