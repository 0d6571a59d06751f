"""Train, prefill and serve steps of the LM plane, their inputs' shapes,
and the shapes of the trees they carry.

Counterpart of ``repro.launch.steps``. The reference jit-compiles these for
a mesh; the port runs them eagerly, on plain tensors on one device or on
trees laid out as DTensors over a mesh (``sharding.specs.distribute_tree``;
``launch.dryrun`` traces both on the ``meta`` device). A step given
DTensors runs under ``implicit_replication``, so that the plain constants
it makes (positions, rope tables, masks, zeros) enter as replicated; the
kernel ops take DTensors through their own entry (``kernels.ops``), and
nothing else of a step changes. ``input_specs``,
``param_shapes``, ``opt_shapes`` and ``cache_shapes`` return trees of
``meta`` tensors (shape and dtype, no storage) where the reference returns
``jax.eval_shape``'s ``ShapeDtypeStruct``s, so a full-size model can be
sized without a byte of it.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import on_meta
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import whole_on
from repro_torch.models.transformer import (
    ModelOpts,
    forward_decode,
    forward_prefill,
    forward_train,
    init_cache,
    init_params,
)
from repro_torch.optim import adamw_init, adamw_update_, clip_by_global_norm
from repro_torch.sharding.specs import axes_entry
from repro_torch.tree import tree_leaves, tree_unflatten


def default_opts(cfg, mesh=None, *, seq_parallel: bool = False, **overrides) -> ModelOpts:
    """``ModelOpts`` adapted to a mesh, the reference's rules: KV heads
    replicated ``kv_mult`` times to tile the model axis where GQA grouping
    survives it, chunked attention for long sequences (``attn_chunk=1024``),
    routed experts padded to a multiple of the model axis
    (``expert_pad_to``), ``remat=True``; ``seq_parallel`` with a model axis
    over one device adds the sequence-parallel residual spec (``act_spec``
    = (data axes, "model", None)). ``mesh`` is a ``launch.mesh.MeshSpec``,
    a ``DeviceMesh`` or None (one device: ``kv_mult=1``,
    ``expert_pad_to=1``, no ``act_spec``); ``overrides`` replace any
    field."""
    sizes = axis_sizes(mesh)
    tp = sizes.get("model", 1)
    kv_mult = 1
    if (
        tp > 1
        and cfg.num_kv_heads
        and cfg.num_kv_heads < tp
        and tp % cfg.num_kv_heads == 0
        # replication must keep GQA grouping: q heads must tile the
        # replicated kv heads (llama3.2's 24q / 8kv cannot replicate to 16)
        and cfg.num_heads % (cfg.num_kv_heads * (tp // cfg.num_kv_heads)) == 0
    ):
        kv_mult = tp // cfg.num_kv_heads
    act_spec = None
    if seq_parallel and mesh is not None and tp > 1:
        act_spec = (axes_entry(tuple(a for a in ("pod", "data") if a in sizes)), "model", None)
    kw = dict(kv_mult=kv_mult, attn_chunk=1024,
              expert_pad_to=tp if tp > 1 and cfg.num_experts else 1, remat=True,
              act_spec=act_spec)
    kw.update(overrides)
    return ModelOpts(**kw)


def input_specs(cfg, batch: int, seq: int, mode: str) -> dict[str, torch.Tensor]:
    """The batch of one (arch, batch, seq, mode) workload as tensors on the
    ``meta`` device (shape and dtype, no storage), the reference's
    ``input_specs`` with its ``ShapeDtypeStruct``s.

    ``mode`` is ``"train"``, ``"prefill"`` or ``"decode"``. VLM
    (``vision_stub``): ``seq`` counts media + text, split as
    ``media = min(num_media_tokens, seq // 2)`` rows of patch embeddings
    and ``seq - media`` tokens. Audio (``enc_dec``): ``seq`` is the
    decoder's length, and the encoder takes (batch, enc_seq_len, d_model)
    stubbed frame embeddings. Embeddings have the compute dtype, token ids
    int32. Decode is one token against a ``seq``-long cache."""
    cdt = getattr(torch, cfg.compute_dtype)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    if mode == "decode":
        return {"token": spec((batch, 1), torch.int32), "pos": spec((), torch.int32)}
    text = seq
    specs: dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision_stub":
        media = min(cfg.num_media_tokens, seq // 2)
        text = seq - media
        specs["media"] = spec((batch, media, cfg.d_model), cdt)
    specs["tokens"] = spec((batch, text), torch.int32)
    if mode == "train":
        specs["labels"] = spec((batch, text), torch.int32)
    if cfg.enc_dec:
        specs["frames"] = spec((batch, cfg.enc_seq_len, cfg.d_model), cdt)
    return specs


def param_shapes(cfg, opts: ModelOpts):
    """``init_params``' tree as ``meta`` tensors: the reference's
    ``param_shapes``, whatever the model's size."""
    with on_meta():
        return init_params(cfg, opts, device="cpu")


def opt_shapes(params_shapes):
    """``adamw_init``'s tree over ``param_shapes``' as ``meta`` tensors:
    fp32 moments shaped like the params, an int32 step counter."""
    with on_meta():
        return adamw_init(params_shapes)


def cache_shapes(cfg, opts: ModelOpts, batch: int, seq: int, dtype=None):
    """``init_cache``'s decode states for ``batch`` sequences of a
    ``seq``-long cache, as ``meta`` tensors, in ``dtype`` (the compute dtype
    by default) as the reference's ``cache_shapes``."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    with on_meta():
        return init_cache(cfg, opts, batch, seq, dtype, device="cpu")


def _scope(params):
    """``implicit_replication`` for a step over DTensor params (its first
    leaf is one), else nothing: the plain constants a laid-out step makes
    are replicated."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tree_leaves(params)[0], DTensor):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


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
        with _scope(params):
            return _train(params, opt_state, batch)

    def _train(params, opt_state, batch):
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
        with _scope(params):
            return forward_prefill(cfg, opts, params, batch)

    return prefill_step


def make_serve_step(cfg, opts: ModelOpts):
    """One greedy decode step: (next_token int32 (B,), logits, cache)."""

    def serve_step(params, cache, batch):
        with _scope(params):
            return _serve(params, cache, batch)

    def _serve(params, cache, batch):
        logits, new_cache = forward_decode(cfg, opts, params, batch, cache)
        # the vocabulary whole on each device (DTensor's argmax over a
        # sharded one fails on some meshes)
        next_token = torch.argmax(whole_on(logits, -1), dim=-1).to(torch.int32)
        return next_token, logits, new_cache

    return serve_step
