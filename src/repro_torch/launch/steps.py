"""Train, prefill and serve steps of the LM plane.

Counterpart of ``repro.launch.steps``. The reference jit-compiles these for
a mesh; the port runs them eagerly on one device.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import (
    ModelOpts,
    forward_decode,
    forward_prefill,
    forward_train,
)
from repro_torch.optim import adamw_update_, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_unflatten


def default_opts(cfg, **overrides) -> ModelOpts:
    """The reference's ``default_opts`` on a one-device mesh: no KV
    replication (``kv_mult=1``), routed experts padded to a multiple of
    the mesh's one model-parallel device (``expert_pad_to=1``: no padding),
    chunked attention for long sequences (``attn_chunk=1024``),
    ``remat=True``; ``overrides`` replace any field."""
    kw = dict(kv_mult=1, expert_pad_to=1, attn_chunk=1024, remat=True)
    kw.update(overrides)
    return ModelOpts(**kw)


def make_train_step(cfg, opts: ModelOpts, *, lr: float = 3e-4, clip: float = 1.0):
    """One training step: the gradient of ``forward_train`` over the param
    leaves (autograd), ``clip_by_global_norm``, then AdamW.

    The update is written into ``params`` and ``opt_state`` in place
    (``optim.adamw_update_``, the reference's arithmetic bit for bit), so a
    full-size model never holds two copies of its fp32 moments; the step
    returns the same objects, as (params, opt_state, {"loss", "ce",
    "grad_norm", "lb_loss"}), the metrics as 0-d tensors on the params'
    device."""

    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, aux = forward_train(cfg, opts, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        del leaves
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads), clip)
        params, opt_state = adamw_update_(grads, opt_state, params, lr=lr)
        metrics = {"loss": loss.detach(), "ce": aux["ce"].detach(), "grad_norm": gnorm,
                   "lb_loss": aux["lb_loss"].detach()}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg, opts: ModelOpts):
    def prefill_step(params, batch):
        return forward_prefill(cfg, opts, params, batch)

    return prefill_step


def make_serve_step(cfg, opts: ModelOpts):
    """One greedy decode step: (next_token int32 (B,), logits, cache)."""

    def serve_step(params, cache, batch):
        logits, new_cache = forward_decode(cfg, opts, params, batch, cache)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step
