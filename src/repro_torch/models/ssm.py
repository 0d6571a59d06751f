"""Attention-free sequence mixer: RWKV6 ("Finch").

Counterpart of the RWKV6 part of ``repro.models.ssm``. The recurrence of
``rwkv6_time_mix`` is one ``ops.rwkv6_scan`` call: the hand-written kernels
on the card (forward, and backward under autograd), their plain versions on
the CPU. ``rwkv6_time_mix_chunked`` is the reference's chunk-parallel form
(``ModelOpts.rwkv_chunk``) in torch ops under autograd; it calls no kernel.
Mamba2 waits (ROADMAP A6.3).

Layouts: x (B, S, d). Recurrent state:
  {"tm_x": (B, d), "cm_x": (B, d), "s": (B, H, hd, hd) fp32}
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, mm

LORA_R = 32  # rank of the data-dependent mixing/decay LoRAs


def init_rwkv6(gen: torch.Generator, cfg, dtype):
    d = cfg.d_model
    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        # token-shift mixing coefficients (r, w, k, v, g + base)
        "mu_base": zeros(d),
        "mu": zeros(5, d),
        # data-dependent mixing LoRA: (d -> r -> 5*d)
        "lora_A": dense_init(gen, d, 5 * LORA_R, dtype),
        "lora_B": torch.zeros((5 * LORA_R, 5 * d), dtype=dtype, device=dev),
        # projections
        "wr": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wg": dense_init(gen, d, d, dtype),
        "wo": dense_init(gen, d, d, dtype, scale=d**-0.5),
        # decay: w0 + lora
        "w0": full((d,), -6.0),
        "decay_A": dense_init(gen, d, LORA_R, dtype),
        "decay_B": torch.zeros((LORA_R, d), dtype=dtype, device=dev),
        # per-channel bonus u
        "u": zeros(H, hd),
        # output groupnorm (per head)
        "ln_scale": full((d,), 1.0),
        "ln_bias": zeros(d),
        # channel-mix
        "cm_mu_k": zeros(d),
        "cm_mu_r": zeros(d),
        "cm_wk": dense_init(gen, d, cfg.d_ff, dtype),
        "cm_wv": dense_init(gen, cfg.d_ff, d, dtype),
        "cm_wr": dense_init(gen, d, d, dtype),
    }


def _rwkv6_inputs(p, x, x_prev):
    """Compute r,k,v,g,w for a sequence. x: (B,S,d); x_prev: shifted x."""
    dx = x_prev - x
    xxx = x + dx * p["mu_base"]
    lora = mm(torch.tanh(mm(xxx, p["lora_A"])), p["lora_B"])  # (B,S,5d)
    d = x.shape[-1]
    mix = p["mu"][None, None] + lora.reshape(*x.shape[:-1], 5, d)
    xs = x[..., None, :] + dx[..., None, :] * mix  # (B,S,5,d)
    x_r, x_w, x_k, x_v, x_g = (xs[..., i, :] for i in range(5))
    r = mm(x_r, p["wr"])
    k = mm(x_k, p["wk"])
    v = mm(x_v, p["wv"])
    g = F.silu(mm(x_g, p["wg"]))
    decay = p["w0"] + mm(torch.tanh(mm(x_w, p["decay_A"])), p["decay_B"])
    w = torch.exp(-torch.exp(decay.to(torch.float32)))  # (B,S,d) in (0,1)
    return r, k, v, g, w


def _heads(x, H, hd):
    return x.reshape(*x.shape[:-1], H, hd)


def _group_norm(x, scale, bias, H, eps=1e-5):
    """Per-head groupnorm on (B,S,d)."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], H, shp[-1] // H).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale + bias).to(x.dtype)


def _shift(x_last, x):
    """The token-shifted sequence: the state's last token, then x[:, :-1],
    in the promoted dtype, as jnp.concatenate gives."""
    dt = torch.promote_types(x_last.dtype, x.dtype)
    return torch.cat([x_last[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


def rwkv6_time_mix(cfg, p, x, state):
    """RWKV6 time-mix; the recurrence runs in ``ops.rwkv6_scan``. x: (B,S,d).
    Returns (y, new_state)."""
    B, S, d = x.shape
    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    x_prev = _shift(state["tm_x"], x)
    r, k, v, g, w = _rwkv6_inputs(p, x, x_prev)
    r, k, v, w = (_heads(t, H, hd).to(torch.float32).contiguous() for t in (r, k, v, w))
    ys, s_new = ops.rwkv6_scan(r, k, v, w, p["u"].to(torch.float32).contiguous(),
                               state["s"].to(torch.float32).contiguous())
    y = ys.reshape(B, S, d).to(x.dtype)
    y = _group_norm(y, p["ln_scale"], p["ln_bias"], H)
    y = mm(y * g.to(y.dtype), p["wo"].to(y.dtype)).to(x.dtype)
    return y, {"tm_x": x[:, -1].to(state["tm_x"].dtype), "s": s_new}


def rwkv6_time_mix_chunked(cfg, p, x, state, chunk: int = 64):
    """The same recurrence by the reference's chunk-parallel form: within a
    chunk of ``chunk`` steps, cumulative log decays turn the state's
    contribution and the intra-chunk pairs into products; a loop over the
    chunks (the reference's ``lax.scan``) carries the state. The reference's
    arithmetic, term for term: ``exp(-cum)`` overflows to inf where a
    chunk's decays multiply below fp32's range (ROADMAP C12)."""
    B, S, d = x.shape
    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    if S % chunk:
        raise ValueError(f"rwkv6_time_mix_chunked: chunk {chunk} must divide S = {S}")
    x_prev = _shift(state["tm_x"], x)
    r, k, v, g, w = _rwkv6_inputs(p, x, x_prev)
    nc = S // chunk
    r, k, v, w = (_heads(t, H, hd).to(torch.float32).reshape(B, nc, chunk, H, hd)
                  for t in (r, k, v, w))
    u = p["u"][None]
    logw = torch.log(torch.clamp_min(w, 1e-38))
    cum = torch.cumsum(logw, dim=2)  # within-chunk cumulative log decay
    tj = torch.tril(torch.ones((chunk, chunk), device=x.device), -1)
    s = state["s"].to(torch.float32)
    ys = []
    for c in range(nc):
        r_c, k_c, v_c, cum_c, logw_c = r[:, c], k[:, c], v[:, c], cum[:, c], logw[:, c]
        total = cum_c[:, -1]  # (B, H, hd) total log decay of the chunk
        q_ = r_c * torch.exp(cum_c - logw_c)  # r_t times the decay from the chunk's start to t - 1
        y_state = torch.einsum("bthk,bhkv->bthv", q_, s)
        k_ = k_c * torch.exp(-cum_c)
        att = torch.einsum("bthk,bjhk->bhtj", q_, k_) * tj[None, None]
        diag = torch.einsum("bthk,bthk->bth", r_c, u[:, None] * k_c)  # bonus u * k_t
        y_intra = torch.einsum("bhtj,bjhv->bthv", att, v_c) + diag[..., None] * v_c
        k_dec = k_c * torch.exp(total[:, None] - cum_c)
        s = torch.exp(total)[..., None] * s + torch.einsum("bjhk,bjhv->bhkv", k_dec, v_c)
        ys.append(y_state + y_intra)
    y = torch.stack(ys, 1).reshape(B, S, d).to(x.dtype)
    y = _group_norm(y, p["ln_scale"], p["ln_bias"], H)
    y = mm(y * g.to(y.dtype), p["wo"].to(y.dtype)).to(x.dtype)
    return y, {"tm_x": x[:, -1].to(state["tm_x"].dtype), "s": s}


def rwkv6_channel_mix(cfg, p, x, state):
    x_prev = _shift(state["cm_x"], x)
    dx = x_prev - x
    x_k = x + dx * p["cm_mu_k"]
    x_r = x + dx * p["cm_mu_r"]
    k = torch.square(F.relu(x_k @ p["cm_wk"].to(x_k.dtype)))
    kv = k @ p["cm_wv"].to(k.dtype)
    y = (torch.sigmoid(x_r @ p["cm_wr"].to(x_r.dtype)) * kv).to(x.dtype)
    return y, {"cm_x": x[:, -1].to(state["cm_x"].dtype)}


def init_rwkv6_state(cfg, batch: int, dtype=torch.float32, device=None):
    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "tm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "cm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "s": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    }
