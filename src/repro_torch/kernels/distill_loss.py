"""Fused distillation loss over the vocabulary axis: the wrapper around the
CUDA kernels in ``repro_torch/csrc/distill_loss.cu``.

Counterpart of ``repro.kernels.distill_loss``. Per row i of stacked logits
z and teacher log-probs t,

    L_i = lw * CE(softmax(z_i), y_i) + beta * KL(softmax(z_i) || exp(t_i)),

without materialising softmax(z) in device memory. The native layout is
batched ``(B, N, V)``; ``distill_loss`` is the 2-D B=1 wrapper. The op is a
``torch.autograd.Function``: the forward kernel also writes per-row
``(logZ, KL)``, from which the backward kernel computes

    dz = g * [lw * (softmax(z) - onehot_y) + beta * softmax(z) * ((z - logZ - t) - KL)].

Gradients flow to the logits only (the teacher is a constant under online
distillation). z and t are fp32 or bf16, one dtype for both, as the TPU
kernel takes them: the kernels widen every element to fp32, compute and
keep loss and stats in fp32, and write dz in z's dtype (bf16 is the LM
training loss's case). On a CUDA tensor the wrapper launches the kernels or
raises; on a CPU tensor it computes the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R

# entry-point suffix per logits dtype; both count as distill_loss_fwd / _bwd launches
_ENTRY = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check(z, t, y):
    if z.dim() != 3 or t.shape != z.shape or y.shape != z.shape[:2]:
        raise ValueError(
            f"distill_loss: want z, t (B, N, V) and y (B, N); got "
            f"{tuple(z.shape)}, {tuple(t.shape)}, {tuple(y.shape)}")
    if z.dtype not in _ENTRY or t.dtype != z.dtype:
        raise TypeError(
            f"distill_loss: the kernel takes fp32 or bf16 z and t of one dtype, got "
            f"{z.dtype}, {t.dtype}")
    if z.shape[-1] == 0:
        raise ValueError("distill_loss: empty vocabulary axis")
    if not (z.device == t.device == y.device):
        raise ValueError("distill_loss: z, t and y must share a device")


def _fwd_cuda(z, t, y32, beta, label_weight):
    _lib.check_cuda("distill_loss", z, t, y32)
    B, N, V = z.shape
    loss = torch.empty((B, N), dtype=torch.float32, device=z.device)
    stats = torch.empty((B, N, 2), dtype=torch.float32, device=z.device)
    _lib.launch("distill_loss_fwd" + _ENTRY[z.dtype], z.device, z.data_ptr(),
                t.data_ptr(), y32.data_ptr(), loss.data_ptr(), stats.data_ptr(), B * N,
                V, float(beta), float(label_weight), count_as="distill_loss_fwd")
    return loss, stats


def _bwd_cuda(z, t, y32, stats, g, beta, label_weight):
    _lib.check_cuda("distill_loss", z, t, y32, stats, g)
    B, N, V = z.shape
    dz = torch.empty_like(z)
    _lib.launch("distill_loss_bwd" + _ENTRY[z.dtype], z.device, z.data_ptr(),
                t.data_ptr(), y32.data_ptr(), stats.data_ptr(), g.data_ptr(),
                dz.data_ptr(), B * N, V, float(beta), float(label_weight),
                count_as="distill_loss_bwd")
    return dz


class DistillLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, teacher_logprobs, labels, beta, label_weight):
        _check(logits, teacher_logprobs, labels)
        ctx.beta, ctx.label_weight = beta, label_weight
        if logits.is_cuda:
            y32 = _lib.check_labels("distill_loss", labels, logits.shape[-1])
            loss, stats = _fwd_cuda(logits, teacher_logprobs, y32, beta,
                                    label_weight)
            ctx.save_for_backward(logits, teacher_logprobs, y32, stats)
            return loss
        loss = R.distill_loss_batched_ref(logits, labels, teacher_logprobs,
                                          beta, label_weight)
        ctx.save_for_backward(logits, teacher_logprobs, labels, None)
        return loss

    @staticmethod
    def backward(ctx, g):
        z, t, y, stats = ctx.saved_tensors
        if z.is_cuda:
            dz = _bwd_cuda(z, t, y, stats, g.contiguous(), ctx.beta,
                           ctx.label_weight)
        else:
            dz = R.distill_loss_grad_ref(z, y, t, ctx.beta, ctx.label_weight, g=g)
        return dz, None, None, None, None


def distill_loss_batched(logits, teacher_logprobs, labels, beta=1.0,
                         label_weight=1.0):
    """Per-row fused CE + beta*KL over stacked pairs.

    logits/teacher_logprobs: (B, N, V), both fp32 or both bf16; labels:
    (B, N) in [0, V). Returns (B, N) fp32 losses from one forward launch (and one backward launch
    under autograd). Differentiable w.r.t. ``logits`` only."""
    return DistillLoss.apply(logits, teacher_logprobs, labels, beta,
                             label_weight)


def distill_loss(logits, teacher_logprobs, labels, beta=1.0, label_weight=1.0):
    """2-D (N, V) entry point: B=1 slice of the batched op."""
    return distill_loss_batched(
        logits[None], teacher_logprobs[None], labels[None], beta, label_weight,
    )[0]
