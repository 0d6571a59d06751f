"""Public entry points of the port's kernels, mirroring
``repro.kernels.ops``.

On a CUDA tensor each op launches its hand-written kernel (built at first
use) or raises; on a CPU tensor it runs the plain version in ``ref.py``.
``launches`` counts kernel launches by name (``distill_loss_fwd``,
``distill_loss_bwd``, ``skr_rectify``, ``flash_attention``,
``flash_attention_empty_rows``, ``rwkv6_scan``, ``rwkv6_scan_bwd``, the
last launched in ``rwkv6_scan``'s backward); ``reset_launches`` zeroes
it, and also ``kernels.skr_rectify.variant_launches``, skr_rectify's
launches per entry (``map``, ``fused``),
``kernels.distill_loss.variant_launches``, distill_loss's
launches per entry and kernel (``fwd:regs``, ``fwd_ce:stream``,
``bwd_ce:slices``, ...), ``kernels.flash_attention.variant_launches``,
flash_attention's (``sm90``, ``tf32x3``, ``decode``, and ``latent_decode``,
whose launches also count as ``flash_attention``),
``kernels.flash_attention.sm90_launches``, the ``sm90`` ones per (H, Hv)
instance,
and
``kernels.rwkv6_scan.variant_launches``, rwkv6_scan's (``seq``,
``chunked``).

Every op runs under :func:`_traced`: with a tracer active (see
``repro_torch.obs.trace``) it is a ``kernel.<name>`` span and an
observation of ``kernel_dispatch_seconds{kernel=<name>}``. On CUDA, whose
launches are asynchronous, both time the host's dispatch of the op (and any
sync the op makes, such as the student step's label check), not the
kernel's device time; distill_loss's backward launches inside
``loss.backward()``, outside the forward's span.
"""
from __future__ import annotations

import time

from repro_torch.kernels import ref as R
from repro_torch.kernels._lib import launches, reset_launches  # noqa: F401
from repro_torch.kernels.distill_loss import (
    distill_loss as _distill_loss,
    distill_loss_batched as _distill_loss_batched,
    softmax_xent as _softmax_xent,
    softmax_xent_batched as _softmax_xent_batched,
)
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import latent_decode as _latent
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _rwkv6
from repro_torch.kernels.skr_rectify import (
    skr_process_batched as _skr_process_batched,
    skr_process_rows as _skr_process_rows,
    skr_rectify as _skr,
    skr_rectify_batched as _skr_batched,
)
from repro_torch.obs.metrics import global_registry
from repro_torch.obs.trace import active_tracer


def _traced(kernel: str, fn, *args, **kw):
    """Run a kernel op under the active tracer (no-op — a single global
    read — when tracing is off). Records a host span plus a
    ``kernel_dispatch_seconds{kernel=...}`` latency histogram in the global
    metrics registry. Adds no sync: on CUDA both measure host dispatch."""
    tr = active_tracer()
    if tr is None:
        return fn(*args, **kw)
    t0 = time.perf_counter()
    with tr.span(f"kernel.{kernel}", cat="kernel"):
        out = fn(*args, **kw)
    global_registry().histogram(
        "kernel_dispatch_seconds", kernel=kernel
    ).observe(time.perf_counter() - t0)
    return out


def fused_softmax_xent(logits, labels):
    """Per-row CE without materializing softmax: distill_loss's CE entry
    (beta = 0), which takes no teacher, so none is allocated."""
    return _traced("softmax_xent", _softmax_xent, logits, labels)


def fused_softmax_xent_batched(logits, labels):
    """Per-row CE of stacked pairs (B, N, V): one launch of the CE entry
    forward and one backward for the whole group."""
    return _traced("softmax_xent_batched", _softmax_xent_batched, logits,
                   labels)


def fused_distill_loss(logits, teacher_logprobs, labels, *, beta: float,
                       label_weight: float = 1.0):
    """Fused Eq.(3)/(32): CE + beta*KL per row (autograd, vocab-streamed)."""
    return _traced("distill_loss", _distill_loss, logits, teacher_logprobs,
                   labels, beta, label_weight)


def fused_distill_loss_batched(logits, teacher_logprobs, labels, *,
                               beta: float, label_weight: float = 1.0):
    """Batched Eq.(3)/(32) over stacked pairs (B, N, V) — one kernel
    launch forward and one backward for the whole group."""
    return _traced("distill_loss_batched", _distill_loss_batched, logits,
                   teacher_logprobs, labels, beta, label_weight)


def skr_rectify(probs, labels, qbar, counts):
    return _traced("skr_rectify", _skr, probs, labels, qbar, counts)


def skr_rectify_batched(probs, labels, qbar, counts):
    """Stacked (B, N, C) rectification with per-pair (B, C) queue stats."""
    return _traced("skr_rectify_batched", _skr_batched, probs, labels, qbar,
                   counts)


def skr_process(probs, labels, q, count, head):
    """SKR's Algorithm 2 for one teacher step (N, C): the queue pass and
    Eq. (31) in one launch. Returns (Q, q, count, head)."""
    return _traced("skr_process", _skr_process_rows, probs, labels, q, count,
                   head)


def skr_process_batched(probs, labels, q, count, head):
    """SKR's Algorithm 2 for one teacher step of B stacked pairs: probs
    (B, N, C), queue states q (B, C, Bq), count and head (B, C), in one
    launch, one block per pair. Returns (Q, q, count, head)."""
    return _traced("skr_process_batched", _skr_process_batched, probs,
                   labels, q, count, head)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """GQA attention, q (B, Sq, N, H), k (B, Sk, K, H), v (B, Sk, K, Hv),
    absolute-position causal / sliding-window masks with the queries at
    ``q_offset``; (B, Sq, N, Hv) in q's dtype."""
    return _traced("flash_attention", _flash, q, k, v, causal=causal,
                   window=window, q_offset=q_offset)


def latent_decode(q, c_kv, k_rope, *, scale, q_offset):
    """MLA's absorbed decode over the compressed cache: q (B, 1, N, L + R)
    fp32 against c_kv (B, S, L) joined to k_rope (B, S, R), c_kv also the
    values; ctx (B, 1, N, L) fp32 over the keys at or before ``q_offset``."""
    return _traced("latent_decode", _latent, q, c_kv, k_rope, scale=scale,
                   q_offset=q_offset)


def rwkv6_scan(r, k, v, w, u, s0):
    """RWKV6 recurrence: (y fp32 (B, T, H, hd), final state (B, H, hd, hd));
    differentiable (``kernels.rwkv6_scan.Rwkv6Scan``)."""
    return _traced("rwkv6_scan", _rwkv6, r, k, v, w, u, s0)


# Re-export the plain versions for tests and chip_smoke.py
ref = R
