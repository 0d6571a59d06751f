"""Prefill and serve steps of the LM plane.

Counterpart of the serving half of ``repro.launch.steps``. The reference
jit-compiles these for a mesh; the port runs them eagerly on one device.
``make_train_step`` belongs to the LM training slice (ROADMAP A4).
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import ModelOpts, forward_decode, forward_prefill


def default_opts(cfg) -> ModelOpts:
    """The reference's ``default_opts`` on a one-device mesh: no KV
    replication (``kv_mult=1``)."""
    return ModelOpts(kv_mult=1)


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
