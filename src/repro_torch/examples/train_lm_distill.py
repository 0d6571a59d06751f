"""FedEEC at LM scale: cross-tier online distillation between two assigned
architectures, counterpart of ``examples/train_lm_distill.py``.

The "end-tier" model (llama3.2-3b) teaches the "cloud-tier" model
(llama3-8b) over bridge TOKENS. The teacher's temperature softmax goes
through SKR's Algorithm 2 (``core.skr.skr_process_batch``: one launch of
``skr_rectify``'s fused entry on the card), and the student trains on the
rectified knowledge through ``ops.fused_distill_loss`` (CE + beta KL, the
``distill_loss`` kernels' t entry), then takes an AdamW step. The teacher
runs the inference forward (its attention through ``ops.flash_attention``),
the student the training forward (``attention.mha`` under autograd).

``main`` runs the reference's reduced configs (fp32 throughout, vocab 512).
``run`` takes any pair of ``ArchConfig``s, so the same code runs at full
width. There the weights and activations are bf16 (the configs'
``param_dtype`` / ``compute_dtype``), and from the logits on everything is
fp32: the teacher's softmax, SKR's state and Q, the teacher log-probs and
the student's logits into ``distill_loss``. SKR's kernel takes fp32
probabilities, and ``distill_loss`` takes logits and teacher log-probs of
one dtype. Run on bf16 weights, the reference would hand SKR bf16
probabilities.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_distill
    PYTHONPATH=src python -m repro_torch.examples.train_lm_distill --device cpu
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.skr import skr_init, skr_process_batch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.steps import default_opts
from repro_torch.models.layers import mask_padded_logits, mm
from repro_torch.models.transformer import (
    _backbone,
    _embed_tokens,
    _logits_matrix,
    init_params,
)
from repro_torch.optim import adamw_init, adamw_update_
from repro_torch.tree import value_and_grad

B, S, TEMP, BETA = 4, 32, 0.5, 1.5
QUEUE_LEN = 20  # SKR's knowledge queue per class
LR = 1e-3


def pair_opts(cfg):
    """The example's options for either model: one attention block, no remat."""
    return default_opts(cfg, attn_chunk=0, remat=False)


def logits_fn(cfg, opts, params, tokens, *, train):
    """(B, S, V_pad) logits of ``tokens``; ``train`` picks the training
    forward (attention under autograd) or the inference one (the
    ``flash_attention`` kernel)."""
    x = _embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _ = _backbone(cfg, opts, params, x, positions=positions, train=train)
    return mask_padded_logits(mm(h, _logits_matrix(cfg, params).T), cfg.vocab_size)


@torch.no_grad()
def knowledge(skr, z, labels):
    """SKR's Algorithm 2 on the teacher's fp32 logits z (N, V) for rows
    labelled ``labels`` (N,): the temperature softmax P, the rectified
    knowledge Q and SKR's new state, (P, Q, skr)."""
    probs = torch.softmax(z / TEMP, -1)
    skr, q = skr_process_batch(skr, probs, labels)
    return probs, q, skr


@torch.no_grad()
def teacher_knowledge(cfg, opts, params, skr, tokens, labels, vocab):
    """``knowledge`` of the teacher's logits over the first ``vocab``
    classes, one row per token, widened to fp32: (P, Q, skr)."""
    z = logits_fn(cfg, opts, params, tokens, train=False)[..., :vocab].float()
    return knowledge(skr, z.reshape(-1, vocab), labels.reshape(-1))


def log_knowledge(q):
    """The knowledge the student is held to: log(max(Q, 1e-12))."""
    return torch.log(torch.clamp_min(q, 1e-12))


def teach(cfg, opts, params, skr, tokens, labels, vocab):
    """The teacher's log-knowledge, (B * S, vocab) fp32, and SKR's new
    state."""
    _, q, skr = teacher_knowledge(cfg, opts, params, skr, tokens, labels, vocab)
    return log_knowledge(q), skr


def student_loss(cfg, opts, params, tokens, labels, tlogq, vocab):
    """The mean over tokens of CE + BETA KL, through ``fused_distill_loss``
    on the student's fp32 logits."""
    z = logits_fn(cfg, opts, params, tokens, train=True)[..., :vocab]
    return ops.fused_distill_loss(z.reshape(-1, vocab).float(), tlogq, labels.reshape(-1),
                                  beta=BETA).mean()


def student_grads(cfg, opts, params, tokens, labels, tlogq, vocab):
    """(loss, gradient tree) of ``student_loss`` over the student's params."""
    return value_and_grad(
        lambda p: student_loss(cfg, opts, p, tokens, labels, tlogq, vocab), params)


def student_step(cfg, opts, params, opt_state, tokens, labels, tlogq, vocab):
    """One distillation step: the gradient, then AdamW (lr 1e-3, no weight
    decay, no clip) written into ``params`` and ``opt_state``. Returns
    (params, opt_state, loss)."""
    loss, grads = student_grads(cfg, opts, params, tokens, labels, tlogq, vocab)
    params, opt_state = adamw_update_(grads, opt_state, params, lr=LR, weight_decay=0.0)
    return params, opt_state, loss


def token_draws(vocab: int, steps: int):
    """The reference's draws: one (B, S + 1) batch of ids in [1, vocab) a
    step from ``default_rng(0)``, split into (tokens, next-token labels)."""
    rng = np.random.default_rng(0)
    for _ in range(steps):
        toks = rng.integers(1, vocab, (B, S + 1)).astype(np.int32)
        yield toks[:, :-1], toks[:, 1:]


@dataclass
class DistillResult:
    losses: list[float] = field(default_factory=list)  # the student's loss a step
    skr: dict | None = None  # SKR's final state
    params: dict | None = None  # the student's final params
    step_s: list[float] = field(default_factory=list)  # wall s a step, ends in a sync
    pushes: list[int] = field(default_factory=list)  # rows pushed to a queue a step
    rectified: list[int] = field(default_factory=list)  # rows Eq. 31 changed a step


def run(teacher_cfg, student_cfg, *, steps: int, pt=None, ps=None,
        device="cuda") -> DistillResult:
    """``steps`` distillation steps of the teacher into the student over the
    shared vocabulary (the smaller of the two). ``pt`` / ``ps``: the
    teacher's and student's params, else ``init_params`` with seeds 0 and 1
    on ``device``; ``ps`` is trained in place. A row counts as pushed when
    its label's probability is the row's largest (Algorithm 2's push), and
    as rectified when Q differs from P in it."""
    dev = resolve_device(device)
    vocab = min(teacher_cfg.vocab_size, student_cfg.vocab_size)
    opts_t, opts_s = pair_opts(teacher_cfg), pair_opts(student_cfg)
    pt = init_params(teacher_cfg, opts_t, seed=0, device=dev) if pt is None else pt
    ps = init_params(student_cfg, opts_s, seed=1, device=dev) if ps is None else ps
    opt = adamw_init(ps)
    skr = skr_init(vocab, QUEUE_LEN, device=dev)
    res = DistillResult()
    counts = []
    for tokens, labels in token_draws(vocab, steps):
        tokens, labels = (torch.from_numpy(a).to(dev, torch.int64) for a in (tokens, labels))
        t0 = time.perf_counter()
        probs, q, skr = teacher_knowledge(teacher_cfg, opts_t, pt, skr, tokens, labels, vocab)
        ps, opt, loss = student_step(student_cfg, opts_s, ps, opt, tokens, labels,
                                     log_knowledge(q), vocab)
        res.losses.append(float(loss))  # a sync
        res.step_s.append(time.perf_counter() - t0)
        p_label = probs.gather(1, labels.reshape(-1, 1))[:, 0]
        counts.append(torch.stack([(p_label >= probs.amax(1)).sum(), (q != probs).any(1).sum()]))
    for pushed, rectified in torch.stack(counts).tolist() if counts else ():
        res.pushes.append(pushed)
        res.rectified.append(rectified)
    res.skr, res.params = skr, ps
    return res


def main(argv=None) -> DistillResult:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_lm_distill")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    teacher_cfg = reduced(get_arch("llama3.2-3b"))
    student_cfg = reduced(get_arch("llama3-8b"))
    # a shared label space (vocab): the equivalence protocol's requirement
    vocab = min(teacher_cfg.vocab_size, student_cfg.vocab_size)
    print(f"teacher={teacher_cfg.name} -> student={student_cfg.name}, V={vocab}")
    res = run(teacher_cfg, student_cfg, steps=args.steps, device=args.device)
    for step, loss in enumerate(res.losses, 1):
        if step % 5 == 0:
            print(f"  step {step:3d} distill loss {loss:.4f}")
    print("done — student distilled through BSBODP+SKR at LM scale")
    return res


if __name__ == "__main__":
    main()
