"""Public entry points of the port's kernels, mirroring
``repro.kernels.ops``.

On a CUDA tensor each op launches its hand-written kernel (built at first
use) or raises; on a CPU tensor it runs the plain version in ``ref.py``.
``launches`` counts kernel launches by name (``distill_loss_fwd``,
``distill_loss_bwd``, ``skr_rectify``, ``flash_attention``,
``flash_attention_empty_rows``, ``rwkv6_scan``); ``reset_launches`` zeroes
it, and also ``kernels.skr_rectify.variant_launches``, skr_rectify's
launches per entry (``map``, ``fused``),
``kernels.distill_loss.variant_launches``, distill_loss's
launches per entry and kernel (``fwd:regs``, ``fwd_ce:stream``,
``bwd_ce:slices``, ...), ``kernels.flash_attention.variant_launches``,
flash_attention's (``sm90``, ``tf32x3``, ``decode``),
``kernels.flash_attention.sm90_launches``, the ``sm90`` ones per head_dim,
and
``kernels.rwkv6_scan.variant_launches``, rwkv6_scan's (``seq``,
``chunked``).
"""
from __future__ import annotations

from repro_torch.kernels import ref as R
from repro_torch.kernels._lib import launches, reset_launches  # noqa: F401
from repro_torch.kernels.distill_loss import (
    distill_loss as _distill_loss,
    distill_loss_batched as _distill_loss_batched,
    softmax_xent as _softmax_xent,
    softmax_xent_batched as _softmax_xent_batched,
)
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _rwkv6
from repro_torch.kernels.skr_rectify import (
    skr_process_batched as _skr_process_batched,
    skr_process_rows as _skr_process_rows,
    skr_rectify as _skr,
    skr_rectify_batched as _skr_batched,
)


def fused_softmax_xent(logits, labels):
    """Per-row CE without materializing softmax: distill_loss's CE entry
    (beta = 0), which takes no teacher, so none is allocated."""
    return _softmax_xent(logits, labels)


def fused_softmax_xent_batched(logits, labels):
    """Per-row CE of stacked pairs (B, N, V): one launch of the CE entry
    forward and one backward for the whole group."""
    return _softmax_xent_batched(logits, labels)


def fused_distill_loss(logits, teacher_logprobs, labels, *, beta: float,
                       label_weight: float = 1.0):
    """Fused Eq.(3)/(32): CE + beta*KL per row (autograd, vocab-streamed)."""
    return _distill_loss(logits, teacher_logprobs, labels, beta, label_weight)


def fused_distill_loss_batched(logits, teacher_logprobs, labels, *,
                               beta: float, label_weight: float = 1.0):
    """Batched Eq.(3)/(32) over stacked pairs (B, N, V) — one kernel
    launch forward and one backward for the whole group."""
    return _distill_loss_batched(logits, teacher_logprobs, labels, beta,
                                 label_weight)


def skr_rectify(probs, labels, qbar, counts):
    return _skr(probs, labels, qbar, counts)


def skr_rectify_batched(probs, labels, qbar, counts):
    """Stacked (B, N, C) rectification with per-pair (B, C) queue stats."""
    return _skr_batched(probs, labels, qbar, counts)


def skr_process(probs, labels, q, count, head):
    """SKR's Algorithm 2 for one teacher step (N, C): the queue pass and
    Eq. (31) in one launch. Returns (Q, q, count, head)."""
    return _skr_process_rows(probs, labels, q, count, head)


def skr_process_batched(probs, labels, q, count, head):
    """SKR's Algorithm 2 for one teacher step of B stacked pairs: probs
    (B, N, C), queue states q (B, C, Bq), count and head (B, C), in one
    launch, one block per pair. Returns (Q, q, count, head)."""
    return _skr_process_batched(probs, labels, q, count, head)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """GQA attention, q (B, Sq, N, H), k/v (B, Sk, K, H), absolute-position
    causal / sliding-window masks with the queries at ``q_offset``."""
    return _flash(q, k, v, causal=causal, window=window, q_offset=q_offset)


def rwkv6_scan(r, k, v, w, u, s0):
    """RWKV6 recurrence: (y fp32 (B, T, H, hd), final state (B, H, hd, hd))."""
    return _rwkv6(r, k, v, w, u, s0)


# Re-export the plain versions for tests and chip_smoke.py
ref = R
