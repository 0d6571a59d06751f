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

The reference's ``constrain`` (an expert-sharding constraint on the
dispatch buffers, ``ModelOpts.moe_constrain``) lays out a sharded array;
the port's model runs on plain tensors on one device and refuses the
option until a DTensor reaches it (ROADMAP A7.7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, mm


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


def moe_forward(cfg, params, x, *, capacity_factor: float | None = None):
    """x: (B, S, d). Returns (y, aux) where aux = {"lb_loss", "router_z"},
    fp32 scalars.

    Top-k routing with renormalised weights (DeepSeek / Qwen style); the
    capacity per expert is ``max(8, int(B * S * k * cf / E_real))``.
    """
    B, S, d = x.shape
    T = B * S
    k = cfg.moe_top_k
    e_pad = params["router"].shape[-1]
    e_real = cfg.num_experts
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    cap = max(8, int(T * k * cf / e_real))

    xt = x.reshape(T, d)
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
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    # each kept (expert, slot) is written once; only the sliced-off slot
    # ``cap`` takes several rows, and its value is never read
    buf = x.new_zeros((e_pad, cap + 1, d)).index_put((flat_e, safe_pos), xt[tok_idx])
    yb = _expert_act(cfg, params, buf[:, :cap])  # (E, cap, d)

    # gather back: a dropped slot reads the zero row at ``cap``
    yb = torch.cat([yb, yb.new_zeros((e_pad, 1, d))], dim=1)
    gathered = yb[flat_e, safe_pos] * top_w.reshape(-1)[:, None].to(x.dtype)
    slots = gathered.to(x.dtype).reshape(T, k, d)
    y = slots[:, 0]
    for j in range(1, k):
        y = y + slots[:, j]

    if cfg.shared_d_ff:
        y = y + apply_mlp(cfg, params["shared"], xt)
    return y.reshape(B, S, d), {"lb_loss": lb_loss, "router_z": router_z}
