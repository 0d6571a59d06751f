"""RWKV6 ("Finch") time-mix recurrence, forward only: the wrapper around two
CUDA kernels for the one TPU kernel.

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

The kernels have no backward (nor has the TPU kernel), so on a CUDA tensor
the wrapper raises if grad mode is on and an input requires grad, rather
than return outputs with no ``grad_fn``.

``_lib.launches["rwkv6_scan"]`` counts the calls that launch a kernel,
``variant_launches`` counts them per variant.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R

HEAD_DIMS = (16, 32, 64, 128)
CHUNK = 64  # steps per chunk of the chunked kernel
SEQ_MAX_T = 16  # the longest T the sequential kernel takes (at most CHUNK)

variant_launches = _lib.counter(("seq", "chunked"))


def _variant(T: int) -> str:
    """Which kernel a CUDA call runs: the sequential one for short T (a
    decode step), the chunked scan for the rest."""
    return "seq" if T <= SEQ_MAX_T else "chunked"


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
    variant = _variant(T)
    if variant == "seq":
        _lib.launch("rwkv6_scan", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                    w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
                    B, T, H, hd)
    else:
        # the kernel stages r, k, v, w with 16-byte copies: a view that
        # starts off that grid is copied to a fresh allocation
        r, k, v, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, w))
        nc = -(-T // CHUNK)
        st = torch.empty((B, H, nc, hd, hd), dtype=torch.float32, device=r.device)
        rp = torch.empty_like(r)
        pend = torch.empty((B, H, nc, hd), dtype=torch.float32, device=r.device)
        _lib.launch("rwkv6_scan_chunked", r.device, r.data_ptr(), k.data_ptr(),
                    v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                    sT.data_ptr(), st.data_ptr(), rp.data_ptr(), pend.data_ptr(), B, T, H,
                    hd, CHUNK, count_as="rwkv6_scan")
    variant_launches[variant] += 1
    return y, sT
