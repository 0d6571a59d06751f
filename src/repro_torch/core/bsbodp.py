"""Bridge-Sample-Based Online Distillation Protocol (paper §IV-B),
counterpart of ``repro.core.bsbodp``.

The student optimizes:

  non-leaf (Eq. 3 / Eq. 32):
      L = CE(softmax(f(dec(ε))), y) + β · KL(softmax(f(dec(ε))) || Q)
  leaf (Eq. 5 / Eq. 33):
      L = CE(f(X*), y*) + γ · L_non_leaf

``non_leaf_loss`` and ``leaf_loss`` go through the fused ``distill_loss``
op (a CUDA kernel on the card) with the teacher term t = log(max(Q, 1e-12)),
which is the reference ``kl_div``'s clamp on Q. The reference also clamps
the student probability at 1e-12 inside its CE (``softmax_ce_with_probs``),
which caps a row's CE at -log(1e-12) and zeroes its CE gradient there; the
fused op has no clamp, so the losses subtract relu(CE_row - cap), computed
in plain torch, whose gradient cancels the op's CE gradient exactly where
the reference's vanishes. The reference's student-side clamp inside
``kl_div`` moves each term by at most about 5.5e-11 and is not reproduced.

``non_leaf_loss_batched`` and ``leaf_loss_batched`` are the losses of B
coalesced pairs stacked along a leading axis ((B, N, V) logits): each
returns the (B,) per-pair losses from one launch of each fused entry, and
the gradient of their sum gives every pair its own loss's gradient.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import (
    fused_distill_loss,
    fused_distill_loss_batched,
    fused_softmax_xent,
    fused_softmax_xent_batched,
)

# -log(1e-12) in fp32: the largest CE softmax_ce_with_probs can return
CE_CAP = float(-torch.log(torch.tensor(1e-12, dtype=torch.float32)))


def softmax_ce_with_probs(student_probs, labels):
    """CE between student softmax probs and integer labels (Eq. 3 uses the
    softmax output, not raw logits)."""
    logp = torch.log(torch.clamp_min(student_probs, 1e-12))
    gold = logp.gather(1, labels.long()[:, None])[:, 0]
    return -torch.mean(gold)


def kl_div(p, q):
    """KL(p || q), batched over leading axis, mean-reduced."""
    p = torch.clamp_min(p, 1e-12)
    q = torch.clamp_min(q, 1e-12)
    return torch.mean(torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1))


def _ce_over_cap(logits, labels):
    """Per-row CE in excess of the reference's clamp, relu(CE - cap), over
    the rows of (N, V) or (B, N, V) logits."""
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, labels.long()[..., None])[..., 0]
    return F.relu(ce - CE_CAP)


def _distill_rows(student_logits, labels, teacher_probs, beta, weight):
    """weight · (CE + β·KL) per row of (N, V) or stacked (B, N, V) logits,
    through the fused op (its batched entry for the latter)."""
    t = torch.log(torch.clamp_min(teacher_probs, 1e-12))
    op = fused_distill_loss_batched if student_logits.dim() == 3 else fused_distill_loss
    rows = op(student_logits, t, labels, beta=weight * beta, label_weight=weight)
    return rows - weight * _ce_over_cap(student_logits, labels)


def non_leaf_loss(student_logits, labels, teacher_probs, beta: float):
    """Eq. (3)/(32): the student distills teacher knowledge on bridge samples.

    student_logits: f(dec(ε); W^S); teacher_probs: τ(z^ε/T) or rectified Q.
    """
    return torch.mean(_distill_rows(student_logits, labels, teacher_probs,
                                    beta, 1.0))


def leaf_loss(
    student_logits_local,
    labels_local,
    student_logits_bridge,
    labels_bridge,
    teacher_probs,
    beta: float,
    gamma: float,
):
    """Eq. (5)/(33): local CE on private samples + γ · non-leaf loss on the
    bridge samples of the same embeddings."""
    ce_local = softmax_xent(student_logits_local, labels_local)
    return ce_local + torch.mean(_distill_rows(
        student_logits_bridge, labels_bridge, teacher_probs, beta, gamma))


def non_leaf_loss_batched(student_logits, labels, teacher_probs, beta: float):
    """``non_leaf_loss`` of B stacked pairs: logits and teacher_probs
    (B, N, V), labels (B, N). Returns the (B,) per-pair losses."""
    return _distill_rows(student_logits, labels, teacher_probs, beta, 1.0).mean(-1)


def leaf_loss_batched(student_logits_local, labels_local, student_logits_bridge,
                      labels_bridge, teacher_probs, beta: float, gamma: float):
    """``leaf_loss`` of B stacked pairs ((B, N, V) logits, (B, N) labels):
    the (B,) per-pair losses, the local CE through one launch of the CE
    entry."""
    ce_local = fused_softmax_xent_batched(student_logits_local, labels_local).mean(-1)
    return ce_local + _distill_rows(student_logits_bridge, labels_bridge, teacher_probs,
                                    beta, gamma).mean(-1)


def softmax_xent(logits, labels):
    """Mean CE from logits: the fused op with β = 0."""
    return torch.mean(fused_softmax_xent(logits, labels))


def extract_knowledge(apply_fn: Callable, params, bridge_x, temperature: float):
    """Teacher side: logits + temperature softmax on bridge samples."""
    z = apply_fn(params, bridge_x)
    return z, torch.softmax(z / temperature, dim=-1)
