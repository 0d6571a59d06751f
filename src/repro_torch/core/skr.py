"""Self-Knowledge Rectification (paper §IV-C), counterpart of
``repro.core.skr``.

Per node, per class c, a circular *knowledge queue* of length B stores the
model's own confidence p_c from past *correct* classifications of c-class
bridge samples. Before transmitting knowledge P = softmax(z/T) for a bridge
sample with label c:

  * misattribution test (Eq. 8):  exists i != c with p_i > p_c;
  * if misattributed and the queue is non-empty, rectify (Eq. 31):
        p'_c = mean(queue_c)                      (Gaussian MLE, Eq. 15)
        p'_i = p_i * (1 - p'_c) / (1 - p_c)       (KL projection, i != c)
  * else transmit P unchanged;
  * if correctly attributed, push p_c into queue_c.

``skr_process_batch`` keeps Algorithm 2's per-sample order (later rows of a
class see the pushes of earlier rows, as the reference's ``lax.scan``
does) in one call of ``ops.skr_process``: on the card one kernel launch
runs the queue pass and the rectification of a teacher step's rows.
Given B coalesced pairs' states stacked along a leading axis (the
reference's ``vmap`` of ``skr_process_batch``), it runs the group's
teacher step in one call of ``ops.skr_process_batched``: one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import skr_process, skr_process_batched, skr_rectify


def skr_init(num_classes: int, queue_len: int, device="cpu"):
    return {
        "q": torch.zeros((num_classes, queue_len), dtype=torch.float32,
                         device=device),
        "count": torch.zeros((num_classes,), dtype=torch.int32, device=device),
        "head": torch.zeros((num_classes,), dtype=torch.int32, device=device),
    }


def queue_means(state):
    """Mean of the valid prefix of each class queue; 0 count -> 0."""
    B = state["q"].shape[1]
    valid = torch.arange(B, device=state["q"].device)[None, :] < state["count"][:, None]
    s = torch.sum(state["q"] * valid, dim=1)
    return s / torch.clamp_min(state["count"], 1)


def rectify_given_qbar(probs, labels, qbar, counts):
    """Batched Eq. (31) with precomputed queue means, through the kernel.

    probs: (N, C) temperature-softmax probabilities; labels: (N,);
    qbar/counts: (C,). Returns rectified (N, C).
    """
    return skr_rectify(probs, labels, qbar, counts)


@torch.no_grad()
def skr_process_batch(state, probs, labels):
    """Exact Algorithm-2 semantics: per-sample sequential queue reads and
    pushes, then the rectification, in one launch on the card.

    probs (N, C); labels (N,) on the same device. Returns (new_state, Q)
    where Q (N, C) is the knowledge to transmit; the new state is in new
    tensors. With B pairs stacked (probs (B, N, C), labels (B, N), the
    states' q (B, C, Bq), count and head (B, C)) pair b's result is that of
    its own state and rows.
    """
    op = skr_process_batched if probs.dim() == 3 else skr_process
    Q, q, count, head = op(probs, labels, state["q"], state["count"], state["head"])
    return {"q": q, "count": count, "head": head}, Q
