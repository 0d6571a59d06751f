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

``skr_process_batch`` keeps Algorithm 2's per-sample order in two parts: a
sequential queue pass over the rows (later rows of a class see the pushes
of earlier rows, as the reference's ``lax.scan`` does) yields each row's
(p_c, do, q̄) and the new queue state; the ``skr_rectify`` kernel then
applies Eq. 31 to all rows at once. That split is exact: a row that is not
rectified passes through the kernel unchanged, which is what the scan
writes for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import skr_rectify, skr_rectify_rows


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
    pushes, then one rectification launch.

    probs (N, C); labels (N,) on the same device. Returns (new_state, Q)
    where Q (N, C) is the knowledge to transmit. The queue pass is a short
    loop of small device ops with no read-back to the host.
    """
    q, count, head = state["q"], state["count"], state["head"]
    C, Bq = q.shape
    dev = probs.device
    labels = labels.long()
    cls = torch.arange(C, device=dev)
    slot = torch.arange(Bq, device=dev)
    p_c = probs.gather(1, labels[:, None])[:, 0]
    correct = probs.argmax(dim=1) == labels
    seen_cnt, seen_qbar = [], []
    for i in range(labels.shape[0]):
        c = labels[i:i + 1]
        cnt = count.gather(0, c)
        hd = head.gather(0, c)
        qrow = q.index_select(0, c)[0]
        seen_cnt.append(cnt)
        seen_qbar.append(torch.sum(qrow * (slot < cnt)) / torch.clamp_min(cnt, 1))
        # push on correct attribution
        push = (cls == c) & correct[i]
        q = torch.where(push[:, None] & (slot == hd)[None, :], p_c[i], q)
        head = torch.where(push, (hd + 1) % Bq, head)
        count = torch.where(push, torch.clamp_max(cnt + 1, Bq), count)
    do = ~correct & (torch.cat(seen_cnt) > 0)
    qbar = torch.cat(seen_qbar)
    Q = skr_rectify_rows(probs, labels, p_c, do, qbar)
    return {"q": q, "count": count, "head": head}, Q

