"""SKR on the card: the wrappers around the CUDA kernels in
``repro_torch/csrc/skr_rectify.cu``.

The rectification map (paper Eq. 31), counterpart of
``repro.kernels.skr_rectify``. Given temperature-softmax probabilities P,
per-row label-class probability p_c, the rectify flag and the label class's
queue mean q̄, produce the knowledge Q:

    Q[i, j] = q̄_i                           if do_i and j == label_i
            = P[i, j]·(1-q̄_i)/(1-p_c_i)     if do_i and j != label_i
            = P[i, j]                        otherwise

``skr_rectify_rows`` takes the per-row values directly;
``skr_rectify_batched`` keeps the reference's signature and derives them
from queue means and counts, as the reference wrapper does.

``skr_process_batched`` (and its one-pair form ``skr_process_rows``) is
SKR's whole Algorithm 2, ``repro.core.skr.skr_process_batch``, for B
independent pairs in one launch: the sequential queue pass over a teacher
step's rows (each row's p_c, misattribution test, queue mean and push) and
the map. It returns Q and the new queue state in new tensors. On the card
the kernel checks the labels and the state itself and reports a fault in a
word of pinned host memory per pair, with no read-back after the launch:
the fault is raised at the next sync the caller makes on the device,
``_lib.check_labels``' (FedEEC's student step makes one before it reads Q),
or by ``_lib.raise_faults``.

On a CUDA tensor each wrapper launches its kernel or raises (and raises
if grad mode is on and an input requires grad: the kernels have no
backward, and a launch through ``data_ptr`` would drop the gradient
without a word); on a CPU tensor it computes the plain version in
``ref.py``; on a ``meta`` tensor
(``launch.dryrun``'s trace) it allocates its outputs on ``meta`` and
reports the kernel's FLOPs (``map_flops``, ``process_flops``) through
``_lib.meta_launch``. The map is
bit-identical either way; the fused entry's queue means are fp32 sums in
slot order, the plain version's ``torch.sum``'s order, so Q may differ in
the last bits (count, head and q are copies and exact).
``_lib.launches["skr_rectify"]`` counts every launch of either kernel, and
``variant_launches`` counts them as ``map`` and ``fused``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R

variant_launches = _lib.counter(("map", "fused"))
# the fused kernel's fault bit for a label outside [0, C); 2 is a bad state
_BAD_LABEL = 1


def map_flops(rows: int, C: int) -> float:
    """The map's operations: a product and a select an element."""
    return float(2 * rows * C)


def process_flops(B: int, N: int, C: int, Bq: int) -> float:
    """The fused entry's operations: 2 N C + N Bq a pair (the argmax and
    the map's products, at most Bq adds a row for the queue mean)."""
    return float(B * (2 * N * C + N * Bq))


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
    if not (probs.is_cuda or probs.is_meta):
        return R.skr_rectify_rows_ref(probs, labels, p_c, do, qb)
    _lib.refuse_grad("skr_rectify", probs, p_c, qb)
    C = probs.shape[-1]
    y32 = _lib.check_labels("skr_rectify", labels, C)
    _lib.check_cuda("skr_rectify", probs, y32, p_c, do, qb)
    out = torch.empty_like(probs)
    _lib.launch("skr_rectify", probs.device, probs.data_ptr(), y32.data_ptr(),
                p_c.data_ptr(), do.data_ptr(), qb.data_ptr(), out.data_ptr(),
                probs.numel() // max(C, 1), C,
                flops=lambda: map_flops(probs.numel() // max(C, 1), C))
    if not probs.is_meta:
        variant_launches["map"] += 1
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


def skr_process_batched(probs, labels, q, count, head):
    """probs (B, N, C) fp32; labels (B, N) int32 or int64 in [0, C); the
    queue state q (B, C, Bq) fp32, count and head (B, C) int32. Returns
    (Q (B, N, C), q, count, head), the new state in new tensors: the input
    state is not written, so a caller that still holds it keeps it. On the
    card a bad label, count or head raises ValueError at the next
    ``_lib.check_labels`` or ``_lib.raise_faults`` on the device; on the
    CPU a bad label raises at once (the plain version's gather)."""
    if probs.dim() != 3 or q.dim() != 3:
        raise ValueError("skr_process: probs must be (B, N, C) and q (B, C, Bq)")
    B, N, C = probs.shape
    _check(probs, labels, q, count, head, (B, N), (B, C))
    if not (probs.is_cuda or probs.is_meta):
        return R.skr_process_batched_ref(probs, labels, q, count, head)
    return _launch(probs, labels, q, count, head, B, N, C)


def skr_process_rows(probs, labels, q, count, head):
    """One pair: probs (N, C); labels (N,); q (C, Bq); count, head (C,).
    Returns (Q (N, C), q, count, head), as ``skr_process_batched`` does."""
    if probs.dim() != 2 or q.dim() != 2:
        raise ValueError("skr_process: probs must be (N, C) and q (C, Bq)")
    N, C = probs.shape
    _check(probs, labels, q, count, head, (N,), (C,))
    if not (probs.is_cuda or probs.is_meta):
        return R.skr_process_ref(probs, labels, q, count, head)
    return _launch(probs, labels, q, count, head, 1, N, C)


def _check(probs, labels, q, count, head, rows, classes):
    if labels.shape != rows or q.shape[:-1] != classes or count.shape != classes \
            or head.shape != classes:
        raise ValueError(
            f"skr_process: for probs {tuple(probs.shape)}, labels must be {rows}, "
            f"q {classes} + (Bq,), count and head {classes}")
    if probs.shape[-1] < 1 or q.shape[-1] < 1:
        raise ValueError("skr_process: needs at least one class and a queue slot")
    if probs.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError("skr_process: probs and q must be fp32")
    if count.dtype != torch.int32 or head.dtype != torch.int32:
        raise TypeError("skr_process: count and head must be int32")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"skr_process: labels must be int32 or int64, got {labels.dtype}")


def _launch(probs, labels, q, count, head, B, N, C):
    """One launch for B pairs. A fault is raised later, from the kernel's
    fault words (``_fault``). Every output is a tensor of its own: one
    allocation each costs the host less than views of a shared one."""
    _lib.check_cuda("skr_process", probs, labels, q, count, head)
    _lib.refuse_grad("skr_process", probs, q)
    Bq = q.shape[-1]
    out, new_q = torch.empty_like(probs), torch.empty_like(q)
    new_count, new_head = torch.empty_like(count), torch.empty_like(head)
    if B == 0:
        return out, new_q, new_count, new_head
    err = _lib.fault_words("skr_process", probs.device, B, _fault)
    _lib.launch("skr_process", probs.device, probs.data_ptr(), labels.data_ptr(),
                int(labels.dtype == torch.int64), q.data_ptr(), count.data_ptr(),
                head.data_ptr(), out.data_ptr(), new_q.data_ptr(), new_count.data_ptr(),
                new_head.data_ptr(), err.data_ptr(), B, N, C, Bq, count_as="skr_rectify",
                flops=lambda: process_flops(B, N, C, Bq))
    if not probs.is_meta:
        variant_launches["fused"] += 1
    return out, new_q, new_count, new_head


def _fault(bits):
    if bits & _BAD_LABEL:
        return ValueError("skr_process: a label lies outside [0, C)")
    return ValueError("skr_process: a queue count lies outside [0, Bq] or a head "
                      "outside [0, Bq)")
