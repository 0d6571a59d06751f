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

``softmax_xent`` (and ``softmax_xent_batched``) is the beta = 0 case with
no teacher at all: its kernels (the CE entries) take no t and never read
one, so a caller allocates none. Gradients flow to the logits only (the
teacher is a constant under online distillation). z and t are fp32 or bf16,
one dtype for both, as the TPU kernel takes them: the kernels widen every
element to fp32, compute and keep loss and stats in fp32, and write dz in
z's dtype (bf16 is the LM training loss's case). On a CUDA tensor the
wrapper launches the kernels or raises; on a CPU tensor it computes the
plain version in ``ref.py``.

On a ``meta`` tensor (``launch.dryrun``'s trace) the op takes the CUDA
path's allocations on ``meta`` and reports the kernels' FLOPs
(``loss_flops``: fp32 operations an element, exp as one; the counts
``chip_smoke.py``'s bounds use) through ``_lib.meta_launch``;
nothing is computed or counted.

Which kernel a CUDA call runs is chosen from integers:

- forward, ``_fwd_variant(rows, V, dtype)``: ``"regs"`` for rows of up to
  ``REG_BYTES`` of z, each held in the registers of ``threads`` threads
  (the smallest power of two from 32 that holds it at ``THREAD_BYTES`` a
  thread); ``"stream"`` for longer rows, a block of ``threads`` per row
  (512 when there are fewer than two rows per SM, else 256);
- backward, ``_bwd_variant(V, dtype)``: ``"rows"``, ``threads`` threads
  per row, for the same rows; ``"slices"``, 256 threads per ``REG_BYTES``
  slice of a longer row.

``_lib.launches["distill_loss_fwd"]`` and ``["distill_loss_bwd"]`` count
every launch of either entry; ``variant_launches`` counts them per entry
and variant (``"fwd:regs"``, ``"fwd_ce:stream"``, ``"bwd_ce:slices"``, ...).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R

# entry-point suffix per logits dtype; all count as distill_loss_fwd / _bwd launches
_ENTRY = {torch.float32: "", torch.bfloat16: "_bf16"}
THREAD_BYTES = 64  # bytes of a row one thread holds: four 16-byte loads
REG_BYTES = 256 * THREAD_BYTES  # the longest row held in registers, 16 KB
SMS = 132  # streaming multiprocessors of an H100 SXM
_LAYOUT = {"regs": 0, "stream": 1}

variant_launches = _lib.counter(
    f"{entry}:{variant}" for entry, variants in
    (("fwd", _LAYOUT), ("fwd_ce", _LAYOUT), ("bwd", ("rows", "slices")),
     ("bwd_ce", ("rows", "slices")))
    for variant in variants)


_OPS = {("fwd", False): 5, ("fwd", True): 7, ("bwd", False): 6, ("bwd", True): 11}


def loss_flops(direction: str, with_t: bool, rows: int, V: int) -> float:
    """fp32 operations of one launch over ``rows`` rows of ``V`` classes:
    5 an element forward and 6 backward for the CE entry, 7 and 11 with a
    teacher."""
    return float(_OPS[(direction, with_t)] * rows * V)


def _row_threads(V: int, itemsize: int) -> int:
    threads = 32
    while threads * THREAD_BYTES < V * itemsize:
        threads *= 2
    return threads


def _fwd_variant(rows: int, V: int, dtype: torch.dtype) -> tuple[str, int]:
    """The forward kernel for ``rows`` rows of ``V`` elements of ``dtype``,
    and its threads per row."""
    if V * dtype.itemsize <= REG_BYTES:
        return "regs", _row_threads(V, dtype.itemsize)
    return "stream", 512 if rows < 2 * SMS else 256


def _bwd_variant(V: int, dtype: torch.dtype) -> tuple[str, int, int]:
    """The backward kernel for rows of ``V`` elements of ``dtype``: its
    name, threads per unit and units (slices) per row."""
    nbytes = V * dtype.itemsize
    if nbytes <= REG_BYTES:
        return "rows", _row_threads(V, dtype.itemsize), 1
    return "slices", 256, -(-nbytes // REG_BYTES)


def _check(z, t, y):
    """t None: the CE entry's inputs."""
    if z.dim() != 3 or (t is not None and t.shape != z.shape) or y.shape != z.shape[:2]:
        raise ValueError(
            f"distill_loss: want z{'' if t is None else ', t'} (B, N, V) and y (B, N); got "
            f"{tuple(z.shape)}, {'' if t is None else f'{tuple(t.shape)}, '}{tuple(y.shape)}")
    if z.dtype not in _ENTRY or (t is not None and t.dtype != z.dtype):
        raise TypeError(
            f"distill_loss: the kernel takes fp32 or bf16 z and t of one dtype, got "
            f"{z.dtype}{'' if t is None else f', {t.dtype}'}")
    if z.shape[-1] == 0:
        raise ValueError("distill_loss: empty vocabulary axis")
    if z.shape[-1] >= 2**31:
        raise ValueError("distill_loss: the kernel takes V < 2^31")
    if z.device != y.device or (t is not None and t.device != z.device):
        raise ValueError("distill_loss: z, t and y must share a device")


def _fwd_cuda(z, t, y32, beta, label_weight):
    """One forward launch: the t entry, or the CE entry when t is None
    (beta must then be 0). Returns (loss, stats)."""
    _lib.check_cuda("distill_loss", z, y32, *(() if t is None else (t,)))
    B, N, V = z.shape
    loss = torch.empty((B, N), dtype=torch.float32, device=z.device)
    stats = torch.empty((B, N, 2), dtype=torch.float32, device=z.device)
    variant, threads = _fwd_variant(B * N, V, z.dtype)
    if t is None:
        if beta:
            raise ValueError("distill_loss: the CE entry is beta = 0")
        entry = "fwd_ce"
        _lib.launch("distill_loss_fwd_ce" + _ENTRY[z.dtype], z.device, z.data_ptr(),
                    y32.data_ptr(), loss.data_ptr(), stats.data_ptr(), B * N, V,
                    float(label_weight), _LAYOUT[variant], threads,
                    count_as="distill_loss_fwd", flops=lambda: loss_flops("fwd", False, B * N, V))
    else:
        entry = "fwd"
        _lib.launch("distill_loss_fwd" + _ENTRY[z.dtype], z.device, z.data_ptr(),
                    t.data_ptr(), y32.data_ptr(), loss.data_ptr(), stats.data_ptr(), B * N,
                    V, float(beta), float(label_weight), _LAYOUT[variant], threads,
                    count_as="distill_loss_fwd", flops=lambda: loss_flops("fwd", True, B * N, V))
    if not z.is_meta:
        variant_launches[f"{entry}:{variant}"] += 1
    return loss, stats


def _bwd_cuda(z, t, y32, stats, g, beta, label_weight):
    """One backward launch: the t entry, or the CE entry when t is None."""
    _lib.check_cuda("distill_loss", z, y32, stats, g, *(() if t is None else (t,)))
    B, N, V = z.shape
    dz = torch.empty_like(z)
    variant, threads, slices = _bwd_variant(V, z.dtype)
    if t is None:
        if beta:
            raise ValueError("distill_loss: the CE entry is beta = 0")
        entry = "bwd_ce"
        _lib.launch("distill_loss_bwd_ce" + _ENTRY[z.dtype], z.device, z.data_ptr(),
                    y32.data_ptr(), stats.data_ptr(), g.data_ptr(), dz.data_ptr(), B * N, V,
                    float(label_weight), threads, slices, count_as="distill_loss_bwd",
                    flops=lambda: loss_flops("bwd", False, B * N, V))
    else:
        entry = "bwd"
        _lib.launch("distill_loss_bwd" + _ENTRY[z.dtype], z.device, z.data_ptr(),
                    t.data_ptr(), y32.data_ptr(), stats.data_ptr(), g.data_ptr(),
                    dz.data_ptr(), B * N, V, float(beta), float(label_weight), threads,
                    slices, count_as="distill_loss_bwd",
                    flops=lambda: loss_flops("bwd", True, B * N, V))
    if not z.is_meta:
        variant_launches[f"{entry}:{variant}"] += 1
    return dz


class DistillLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, teacher_logprobs, labels, beta, label_weight):
        _check(logits, teacher_logprobs, labels)
        ctx.beta, ctx.label_weight = beta, label_weight
        if logits.is_cuda or logits.is_meta:
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
        if z.is_cuda or z.is_meta:
            dz = _bwd_cuda(z, t, y, stats, g.contiguous(), ctx.beta,
                           ctx.label_weight)
        else:
            dz = R.distill_loss_grad_ref(z, y, t, ctx.beta, ctx.label_weight, g=g)
        return dz, None, None, None, None


class SoftmaxXent(torch.autograd.Function):
    """Per-row lw * CE of (B, N, V) logits: the CE entries on the card,
    ``ref.softmax_xent_ref`` / ``ref.softmax_xent_grad_ref`` on the CPU.
    Saves the logits, the labels and the stats, and no teacher."""

    @staticmethod
    def forward(ctx, logits, labels, label_weight):
        _check(logits, None, labels)
        ctx.label_weight = label_weight
        if logits.is_cuda or logits.is_meta:
            y32 = _lib.check_labels("softmax_xent", labels, logits.shape[-1])
            loss, stats = _fwd_cuda(logits, None, y32, 0.0, label_weight)
            ctx.save_for_backward(logits, y32, stats)
            return loss
        ctx.save_for_backward(logits, labels, None)
        return R.softmax_xent_ref(logits, labels, label_weight)

    @staticmethod
    def backward(ctx, g):
        z, y, stats = ctx.saved_tensors
        if z.is_cuda or z.is_meta:
            dz = _bwd_cuda(z, None, y, stats, g.contiguous(), 0.0, ctx.label_weight)
        else:
            dz = R.softmax_xent_grad_ref(z, y, ctx.label_weight, g=g)
        return dz, None, None


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


def softmax_xent_batched(logits, labels, label_weight=1.0):
    """Per-row lw * CE of (B, N, V) fp32 or bf16 logits and (B, N) labels:
    (B, N) fp32 losses from one launch of the CE entry (and one backward
    launch under autograd), with no teacher tensor anywhere."""
    return SoftmaxXent.apply(logits, labels, label_weight)


def softmax_xent(logits, labels, label_weight=1.0):
    """2-D (N, V) entry point: B=1 slice of ``softmax_xent_batched``."""
    return softmax_xent_batched(logits[None], labels[None], label_weight)[0]
