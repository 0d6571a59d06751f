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

The five ops of the LM plane (``flash_attention``, ``latent_decode``,
``rwkv6_scan``, ``fused_softmax_xent``, ``fused_distill_loss``) also take
DTensors (a step laid out over a mesh, ``launch.steps``). Such a call
first redistributes its inputs to the layout under which the kernel's work
is local to a device: the batch over the data axes ("pod", "data") where
it divides them, the heads over "model" where every head count divides it
(else replicated), the whole sequence and every key on each device, a
loss's rows whole (over every axis their count divides). It then runs the
wrapper on each device's shards through ``local_map`` (autograd goes
through it) and returns DTensors of that layout: the hand-written kernel
on the card, its meta entry on ``meta`` (so a trace counts one device's
FLOPs and scratch), the plain version on the CPU. A plain tensor among
DTensor inputs enters as replicated. The redistributions are DTensor's
collectives, which ``launch.dryrun`` records. The other ops (FedEEC's)
take plain tensors only.

Every op runs under :func:`_traced`: with a tracer active (see
``repro_torch.obs.trace``) it is a ``kernel.<name>`` span and an
observation of ``kernel_dispatch_seconds{kernel=<name>}``. On CUDA, whose
launches are asynchronous, both time the host's dispatch of the op (and any
sync the op makes, such as the student step's label check), not the
kernel's device time; distill_loss's backward launches inside
``loss.backward()``, outside the forward's span.
"""
from __future__ import annotations

import math
import sys
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


DATA_AXES = ("pod", "data")


def mesh_of(*tensors):
    """The mesh of the first DTensor among ``tensors``, or None (no DTensor
    can exist before ``torch.distributed.tensor`` is imported, so a plain
    call imports nothing)."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return None
    for t in tensors:
        if isinstance(t, mod.DTensor):
            return t.device_mesh
    return None


def shard_layout(mesh, *, batch_dim=None, batch=0, head_dim=None, heads=()) -> tuple:
    """Placements on ``mesh`` under which a kernel's work is local: tensor
    dimension ``batch_dim`` (of size ``batch``) over the data axes where
    ``batch`` divides their product, ``head_dim`` over "model" where every
    count of ``heads`` divides its size; every other dimension whole."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    ndp = math.prod(sizes[a] for a in DATA_AXES if a in sizes)
    tp = sizes.get("model", 1)
    out = []
    for name in mesh.mesh_dim_names:
        if name in DATA_AXES and batch_dim is not None and batch % ndp == 0:
            out.append(Shard(batch_dim))
        elif name == "model" and head_dim is not None and all(h % tp == 0 for h in heads):
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def rows_layout(mesh, rows: int) -> tuple:
    """A loss's rows (dimension 0) over every mesh axis when ``rows``
    divides the mesh, else over the data axes when it divides theirs; each
    row whole (the vocabulary local)."""
    from torch.distributed.tensor import Shard

    if rows % math.prod(mesh.shape) == 0:
        return (Shard(0),) * mesh.ndim
    return shard_layout(mesh, batch_dim=0, batch=rows)


def on_shards(fn, mesh, inputs, out_placements):
    """``fn`` over each device's shards of ``inputs``, a list of (tensor,
    placements): each redistributed to its placements (a plain tensor
    entering as replicated), ``fn`` run on the local shards through
    ``local_map``, its outputs DTensors of ``out_placements`` (one output's
    placements, or a tuple of them, one an output). An input replicated on
    a mesh axis over which the outputs are split (rwkv6's ``u`` over the
    batch's data axes, mamba2's B and C over the heads' "model") is used by
    every shard of the work there: its gradient on a device is a partial
    sum over that axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    outs = out_placements if isinstance(out_placements[0], tuple) else (out_placements,)
    split = [any(not o[i].is_replicate() for o in outs) for i in range(mesh.ndim)]
    args, placements, grads = [], [], []
    for t, pl in inputs:
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        args.append(t.redistribute(mesh, pl))
        placements.append(pl)
        grads.append(tuple(Partial() if p.is_replicate() and cut else p
                           for p, cut in zip(pl, split)))
    if not isinstance(out_placements[0], tuple):  # one output: local_map takes a list
        out_placements = list(out_placements)
    return local_map(fn, out_placements=out_placements, in_placements=tuple(placements),
                     in_grad_placements=tuple(grads), device_mesh=mesh)(*args)


def fused_softmax_xent(logits, labels):
    """Per-row CE without materializing softmax: distill_loss's CE entry
    (beta = 0), which takes no teacher, so none is allocated."""
    mesh = mesh_of(logits, labels)
    if mesh is not None:
        pl = rows_layout(mesh, logits.shape[0])
        return on_shards(lambda z, y: _traced("softmax_xent", _softmax_xent, z, y), mesh,
                         [(logits, pl), (labels, pl)], pl)
    return _traced("softmax_xent", _softmax_xent, logits, labels)


def fused_softmax_xent_batched(logits, labels):
    """Per-row CE of stacked pairs (B, N, V): one launch of the CE entry
    forward and one backward for the whole group."""
    return _traced("softmax_xent_batched", _softmax_xent_batched, logits,
                   labels)


def fused_distill_loss(logits, teacher_logprobs, labels, *, beta: float,
                       label_weight: float = 1.0):
    """Fused Eq.(3)/(32): CE + beta*KL per row (autograd, vocab-streamed)."""
    mesh = mesh_of(logits, teacher_logprobs, labels)
    if mesh is not None:
        pl = rows_layout(mesh, logits.shape[0])
        return on_shards(
            lambda z, t, y: _traced("distill_loss", _distill_loss, z, t, y, beta, label_weight),
            mesh, [(logits, pl), (teacher_logprobs, pl), (labels, pl)], pl)
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
    if mesh_of(q, k, v) is not None:
        return attention_on_shards(
            lambda q, k, v: _traced("flash_attention", _flash, q, k, v, causal=causal,
                                    window=window, q_offset=q_offset), q, k, v)
    return _traced("flash_attention", _flash, q, k, v, causal=causal,
                   window=window, q_offset=q_offset)


def attention_on_shards(fn, q, k, v):
    """``fn(q, k, v)``, an attention over (B, S, heads, head_dim) DTensors,
    run on each device's shards: the batch over the data axes, the heads
    over "model" where both head counts divide it, every position local
    (``flash_attention``'s DTensor entry, and the training attention
    ``models.attention.mha``, whose folds of batch and heads would
    otherwise meet a sharded head dimension)."""
    mesh = mesh_of(q, k, v)
    pl = shard_layout(mesh, batch_dim=0, batch=q.shape[0], head_dim=2,
                      heads=(q.shape[2], k.shape[2]))
    return on_shards(fn, mesh, [(q, pl), (k, pl), (v, pl)], pl)


def latent_decode(q, c_kv, k_rope, *, scale, q_offset):
    """MLA's absorbed decode over the compressed cache: q (B, 1, N, L + R)
    fp32 against c_kv (B, S, L) joined to k_rope (B, S, R), c_kv also the
    values; ctx (B, 1, N, L) fp32 over the keys at or before ``q_offset``."""
    mesh = mesh_of(q, c_kv, k_rope)
    if mesh is not None:
        B = q.shape[0]
        pq = shard_layout(mesh, batch_dim=0, batch=B, head_dim=2, heads=(q.shape[2],))
        pc = shard_layout(mesh, batch_dim=0, batch=B)
        return on_shards(
            lambda q, c, r: _traced("latent_decode", _latent, q, c, r, scale=scale,
                                    q_offset=q_offset),
            mesh, [(q, pq), (c_kv, pc), (k_rope, pc)], pq)
    return _traced("latent_decode", _latent, q, c_kv, k_rope, scale=scale,
                   q_offset=q_offset)


def rwkv6_scan(r, k, v, w, u, s0):
    """RWKV6 recurrence: (y fp32 (B, T, H, hd), final state (B, H, hd, hd));
    differentiable (``kernels.rwkv6_scan.Rwkv6Scan``)."""
    mesh = mesh_of(r, k, v, w, u, s0)
    if mesh is not None:
        B, H = r.shape[0], r.shape[2]
        px = shard_layout(mesh, batch_dim=0, batch=B, head_dim=2, heads=(H,))
        pu = shard_layout(mesh, head_dim=0, heads=(H,))
        ps = shard_layout(mesh, batch_dim=0, batch=B, head_dim=1, heads=(H,))
        return on_shards(lambda *a: _traced("rwkv6_scan", _rwkv6, *a), mesh,
                         [(r, px), (k, px), (v, px), (w, px), (u, pu), (s0, ps)], (px, ps))
    return _traced("rwkv6_scan", _rwkv6, r, k, v, w, u, s0)


# Re-export the plain versions for tests and chip_smoke.py
ref = R
