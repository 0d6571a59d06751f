"""SKR rectification (paper Eq. 31): the wrapper around the CUDA kernel in
``repro_torch/csrc/skr_rectify.cu``.

Counterpart of ``repro.kernels.skr_rectify``. Given temperature-softmax
probabilities P, per-row label-class probability p_c, the rectify flag and
the label class's queue mean q̄, produce the knowledge Q:

    Q[i, j] = q̄_i                           if do_i and j == label_i
            = P[i, j]·(1-q̄_i)/(1-p_c_i)     if do_i and j != label_i
            = P[i, j]                        otherwise

``skr_rectify_rows`` takes the per-row values directly (what the SKR queue
pass in ``repro_torch.core.skr`` produces); ``skr_rectify_batched`` keeps
the reference's signature and derives them from queue means and counts, as
the reference wrapper does. On a CUDA tensor they launch the kernel or
raise; on a CPU tensor they compute the plain version in ``ref.py``. The
result is bit-identical either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R


def skr_rectify_rows(probs, labels, p_c, do, qb):
    """probs (..., C) fp32; labels (...) int in [0, C); p_c, qb (...) fp32;
    do (...) bool. Returns rectified (..., C)."""
    rows = probs.shape[:-1]
    if labels.shape != rows or p_c.shape != rows or do.shape != rows or qb.shape != rows:
        raise ValueError(
            f"skr_rectify: row arrays must have shape {tuple(rows)}")
    if probs.dtype != torch.float32 or p_c.dtype != torch.float32 or qb.dtype != torch.float32:
        raise TypeError("skr_rectify: probs, p_c and qb must be fp32")
    if do.dtype != torch.bool:
        raise TypeError(f"skr_rectify: do must be bool, got {do.dtype}")
    if not probs.is_cuda:
        return R.skr_rectify_rows_ref(probs, labels, p_c, do, qb)
    C = probs.shape[-1]
    y32 = _lib.check_labels("skr_rectify", labels, C)
    _lib.check_cuda("skr_rectify", probs, y32, p_c, do, qb)
    out = torch.empty_like(probs)
    _lib.launch("skr_rectify", probs.device, probs.data_ptr(), y32.data_ptr(),
                p_c.data_ptr(), do.data_ptr(), qb.data_ptr(), out.data_ptr(),
                probs.numel() // max(C, 1), C)
    return out


def skr_rectify_batched(probs, labels, qbar, counts):
    """probs (B, N, C) fp32; labels (B, N); qbar/counts (B, C). Row
    statistics are torch reductions; the O(B·N·C) map is the kernel."""
    labels = labels.long()
    p_c = probs.gather(-1, labels[..., None])[..., 0]
    mis = probs.argmax(-1) != labels
    do = mis & (counts.gather(-1, labels) > 0)
    qb = qbar.gather(-1, labels)
    return skr_rectify_rows(probs, labels, p_c, do, qb)


def skr_rectify(probs, labels, qbar, counts):
    """2-D (N, C) entry point: B=1 slice of the batched op."""
    return skr_rectify_batched(
        probs[None], labels[None], qbar[None], counts[None])[0]
