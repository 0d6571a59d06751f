"""Mixture-of-Experts FFN: top-k routing with capacity, scatter-based
dispatch into an (E, capacity, d) buffer, shared experts, the aux
load-balance and router-z losses.

Counterpart of ``repro.models.moe``, with the reference's arithmetic:

* Routed experts are padded to a multiple of ``expert_pad_to``
  (``ModelOpts``). Padded experts get -1e30 router logits, so their
  softmax weight is exactly 0: they never receive a token and drop out of
  the aux loss.
* Tokens are ranked within their expert by a cumulative sum over the
  (tokens * k, E) one-hot, token-major and slot-minor; a token whose rank
  reaches the capacity is dropped (it is written to slot ``cap`` of a
  (E, cap + 1, d) buffer, which is sliced off).
* The expert products are batched matrix products over the stacked
  (E, d, ff) weights (library calls: the reference computes them in jnp,
  outside any Pallas kernel). A token's k expert outputs, weighted by the
  renormalised router weights, are summed in slot order in x's dtype, as
  the reference's scatter-add does (no atomics, so bf16 sums do not depend
  on the run); the shared MLP is added last.

With ``constrain`` (``ModelOpts.moe_constrain``) a DTensor step runs
the reference's expert-parallel plan, its layout stated in
``_expert_parallel``: the dispatch buffer and the experts' outputs laid out
("model", None, None), as the reference's ``with_sharding_constraint`` pins
them, so each device holds its experts' slots of every token; the dispatch
and the gather back run on each device's shards under ``local_map``. On
plain tensors, and for a DTensor step without it, the dispatch is the one
below (DTensor then lays out each op by its own rules, which gather the
whole buffer onto every device).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    apply_mlp,
    dense_init,
    flatten_rows,
    init_mlp,
    mm,
    one_axis,
    unflatten_rows,
)
from repro_torch.sharding.specs import constrain as lay_out

EXPERT_SPEC = ("model", None, None)  # the reference's P("model", None, None)


def pad_experts(num_experts: int, multiple: int) -> int:
    return ((num_experts + multiple - 1) // multiple) * multiple


def init_moe(gen: torch.Generator, cfg, dtype, expert_pad_to: int = 1):
    """The router (d, E_pad) in fp32 at scale 0.02, the stacked expert
    weights ``up`` / ``gate`` (E_pad, d, moe_d_ff) and ``down`` (E_pad,
    moe_d_ff, d), and the ``shared`` MLP where the config has one."""
    d = cfg.d_model
    e_pad = pad_experts(cfg.num_experts, expert_pad_to)

    def stack(din, dout):
        return torch.stack([dense_init(gen, din, dout, dtype) for _ in range(e_pad)])

    p = {
        "router": dense_init(gen, d, e_pad, torch.float32, scale=0.02),
        "up": stack(d, cfg.moe_d_ff),
        "down": stack(cfg.moe_d_ff, d),
    }
    if cfg.mlp_act.endswith("_glu"):
        p["gate"] = stack(d, cfg.moe_d_ff)
    if cfg.shared_d_ff:
        p["shared"] = init_mlp(gen, cfg, d, cfg.shared_d_ff, dtype)
    return p


def _expert_act(cfg, p, xb):
    """xb: (E, C, d) -> (E, C, d). Batched expert MLP."""
    if cfg.mlp_act.endswith("_glu"):
        # jax.nn.gelu's default is the tanh approximation
        act = F.silu if cfg.mlp_act == "silu_glu" else (
            lambda t: F.gelu(t, approximate="tanh"))
        h = act(mm(xb, p["gate"])) * mm(xb, p["up"])
    else:
        h = torch.square(F.relu(mm(xb, p["up"])))
    return mm(h, p["down"])


def _top_k(probs, k: int):
    """(weights, experts) of the k largest probabilities per row, largest
    first. ``torch.sort(stable=True)`` keeps equal values in index order,
    so among tied probabilities the lower expert index comes first, as in
    ``jax.lax.top_k``; ``torch.topk`` promises no order for ties."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.gather(probs, 1, idx), idx


def moe_forward(cfg, params, x, *, capacity_factor: float | None = None,
                constrain: bool = False):
    """x: (B, S, d). Returns (y, aux) where aux = {"lb_loss", "router_z"},
    fp32 scalars.

    Top-k routing with renormalised weights (DeepSeek / Qwen style); the
    capacity per expert is ``max(8, int(B * S * k * cf / E_real))``.
    ``constrain`` runs a DTensor step's dispatch, expert products and
    gather back expert-parallel (``_expert_parallel``).
    """
    B, S, d = x.shape
    T = B * S
    k = cfg.moe_top_k
    e_pad = params["router"].shape[-1]
    e_real = cfg.num_experts
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    cap = max(8, int(T * k * cf / e_real))

    # the tokens' rows split over one mesh axis at most: the dispatch and
    # the gather back index them
    xt = flatten_rows(one_axis(x))
    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)  # (T, E_pad)
    if e_pad != e_real:
        pad_mask = torch.arange(e_pad, device=x.device) < e_real
        logits = torch.where(pad_mask[None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)  # (T, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # --- aux losses: Switch-style load balance over the real experts, and
    # the router's z-loss
    flat_e = top_e.reshape(-1)  # (T*k,) token-major, slot-minor
    onehot = F.one_hot(flat_e, e_pad)
    f = onehot.sum(dim=0).to(torch.float32) / (T * k)
    pmean = probs.mean(dim=0)
    lb_loss = e_real * torch.sum(f[:e_real] * pmean[:e_real])
    router_z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # --- dispatch: rank within the expert, drops to slot ``cap``
    rank = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(rank, 1, flat_e[:, None])[:, 0]  # (T*k,)
    safe_pos = torch.where(pos < cap, pos, cap)
    w = top_w.reshape(-1)
    if constrain and hasattr(x, "placements"):
        gathered = _expert_parallel(cfg, params, xt, flat_e, safe_pos, w, cap)
    else:
        tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
        # each kept (expert, slot) is written once; only the sliced-off
        # slot ``cap`` takes several rows, and its value is never read
        buf = x.new_zeros((e_pad, cap + 1, d)).index_put((flat_e, safe_pos), xt[tok_idx])
        yb = _expert_act(cfg, params, buf[:, :cap])  # (E, cap, d)
        # gather back: a dropped slot reads the zero row at ``cap``
        yb = torch.cat([yb, yb.new_zeros((e_pad, 1, d))], dim=1)
        gathered = yb[flat_e, safe_pos] * w[:, None].to(x.dtype)
    slots = gathered.to(x.dtype).reshape(T, k, d)
    y = slots[:, 0]
    for j in range(1, k):
        y = y + slots[:, j]

    if cfg.shared_d_ff:
        y = y + apply_mlp(cfg, params["shared"], xt)
    return unflatten_rows(y, xt, (B, S, d)), {"lb_loss": lb_loss, "router_z": router_z}


def _expert_parallel(cfg, params, xt, flat_e, safe_pos, w, cap):
    """The dispatch, the expert products and the gather back of a DTensor
    step with ``constrain``, as the reference's plan lays them out. The
    token rows (``xt`` (T, d)) and their k slots (``flat_e``, ``safe_pos``,
    ``w`` (T * k,)) are split over the data axes where T divides them, and
    whole over "model". Dispatch: each device writes the rows routed to the
    experts it holds (``EXPERT_SPEC``: E / model of them) into its part of
    the (E, cap, d) buffer; that is a partial sum over the data axes, each
    slot written by one row alone, so summing it is exact, and the sum is
    the buffer ("model", None, None): every token's slots of this device's
    experts. The expert products run on it. Gather back: each device reads
    the slots of its rows that its experts hold, and a zero row for the
    others, a partial sum over "model" that is again exact; it is summed
    before the slots are, so the slots add in slot order as on one device.
    Both run on each device's shards under ``local_map``
    (``kernels.ops.on_shards``). Returns the (T * k, d) weighted expert
    outputs, laid out as the rows."""
    from torch.distributed.tensor import Partial

    from repro_torch.kernels.ops import on_shards, shard_layout
    from repro_torch.sharding.specs import to_placements

    mesh = xt.device_mesh
    e_pad, d, k = params["router"].shape[-1], xt.shape[-1], cfg.moe_top_k
    experts = tuple(to_placements(EXPERT_SPEC, mesh))
    split = [i for i, p in enumerate(experts) if p.is_shard()]
    tp = mesh.shape[split[0]] if split else 1
    if e_pad % tp:
        raise ValueError(f"{e_pad} experts do not split over a model axis of {tp}: pad them "
                         f"(ModelOpts.expert_pad_to)")
    held = e_pad // tp
    first = mesh.get_local_rank(split[0]) * held if split else 0
    rows = shard_layout(mesh, batch_dim=0, batch=xt.shape[0])
    summed = tuple(Partial() if r.is_shard() else p for r, p in zip(rows, experts))
    by_expert = tuple(Partial() if i in split else r for i, r in enumerate(rows))

    def mine(e, pos):
        # a row routed elsewhere goes to, or reads, the slot ``cap`` of the
        # first expert held: sliced off, or a zero row
        e = e - first
        here = (e >= 0) & (e < held)
        return torch.where(here, e, 0), torch.where(here, pos, cap)

    def dispatch(xs, e, pos):
        tok = torch.arange(xs.shape[0], device=xs.device).repeat_interleave(k)
        buf = xs.new_zeros((held, cap + 1, d)).index_put(mine(e, pos), xs[tok])
        return buf[:, :cap]

    def gather(yb, e, pos, ws):
        yb = torch.cat([yb, yb.new_zeros((held, 1, d))], dim=1)
        return yb[mine(e, pos)] * ws[:, None].to(xt.dtype)

    buf = on_shards(dispatch, mesh, [(xt, rows), (flat_e, rows), (safe_pos, rows)], summed)
    yb = lay_out(_expert_act(cfg, params, lay_out(buf, EXPERT_SPEC)), EXPERT_SPEC)
    got = on_shards(gather, mesh, [(yb, experts), (flat_e, rows), (safe_pos, rows), (w, rows)],
                    by_expert)
    return got.redistribute(mesh, rows)
