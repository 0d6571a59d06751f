"""Attention-free sequence mixers: RWKV6 ("Finch") and Mamba2 (SSD).

Counterpart of ``repro.models.ssm``. The recurrence of ``rwkv6_time_mix``
is one ``ops.rwkv6_scan`` call: the hand-written kernels on the card
(forward, and backward under autograd), their plain versions on the CPU.
``rwkv6_time_mix_chunked`` is the reference's chunk-parallel form
(``ModelOpts.rwkv_chunk``) in torch ops under autograd; it calls no kernel.

Mamba2's scan has no Pallas kernel in the reference (it is XLA's
``lax.scan``), so the port runs it in torch ops: one step
(``ref.mamba2_scan_ref``, the reference's recurrence step for step) at
S = 1, which decode runs, and the chunked SSD form
(``mamba2_scan_chunked``) for longer sequences, the same function in
another association, whose products are batched over all chunks so that a
4096-token prefill is a few dozen launches a block, not a step's worth per
token.

Layouts: x (B, S, d). Recurrent states:
  RWKV6:  {"tm_x": (B, d), "cm_x": (B, d), "s": (B, H, hd, hd) fp32}
  Mamba2: {"conv_x": (B, W-1, d_inner), "conv_BC": (B, W-1, 2N), "s": (B, H, P, N)},
          all fp32
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models.layers import (
    dense_init,
    matmul,
    mm,
    pin_grad,
    rmsnorm,
    split_heads,
    whole_on,
)

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
    # (a DTensor's gradient of the split laid out as the split, pin_grad)
    mix = p["mu"][None, None] + pin_grad(lora.reshape(*x.shape[:-1], 5, d))
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
    return split_heads(x, H, hd)


def _group_norm(x, scale, bias, H, eps=1e-5):
    """Per-head groupnorm on (B,S,d)."""
    shp = x.shape
    xh = split_heads(x, H, shp[-1] // H).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    # a DTensor's head_dim whole again (its statistics may have spread it)
    return (whole_on(xh, -1).reshape(shp) * scale + bias).to(x.dtype)


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
    k = torch.square(F.relu(matmul(x_k, p["cm_wk"].to(x_k.dtype))))
    kv = matmul(k, p["cm_wv"].to(k.dtype))
    y = (torch.sigmoid(matmul(x_r, p["cm_wr"].to(x_r.dtype))) * kv).to(x.dtype)
    return y, {"cm_x": x[:, -1].to(state["cm_x"].dtype)}


def init_rwkv6_state(cfg, batch: int, dtype=torch.float32, device=None):
    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "tm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "cm_x": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "s": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    }


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

MAMBA2_CHUNK = 64  # steps a chunk of the chunked scan


def init_mamba2(gen: torch.Generator, cfg, dtype):
    """The reference's leaves, names and dtypes: separate projections
    ``wz`` / ``wx`` / ``wB`` / ``wC`` / ``wdt``, two depthwise conv kernels
    with their biases, and fp32 ``A_log`` / ``dt_bias`` / ``D`` /
    ``norm_scale``."""
    d, din = cfg.d_model, cfg.d_inner
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    if H * P != din:
        raise ValueError(f"mamba2: ssm_heads x ssm_head_dim {H} x {P} != d_inner {din}")
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    W = cfg.conv_width
    return {
        "wz": dense_init(gen, d, din, dtype),
        "wx": dense_init(gen, d, din, dtype),
        "wB": dense_init(gen, d, N, dtype),
        "wC": dense_init(gen, d, N, dtype),
        "wdt": dense_init(gen, d, H, dtype),
        "conv_x": (0.1 * normal(W, din)).to(dtype),
        "conv_b_x": zeros(din),
        "conv_BC": (0.1 * normal(W, 2 * N)).to(dtype),
        "conv_b_BC": zeros(2 * N),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "dt_bias": zeros(H),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_scale": zeros(din),
        "out_proj": dense_init(gen, din, d, dtype, scale=din**-0.5),
    }


def _silu(x):
    """x * sigmoid(x) as two ops, each rounded to x's dtype, as jax.nn.silu
    computes it on bf16."""
    return x * torch.sigmoid(x)


def _causal_conv(w, b, u, conv_state):
    """Causal depthwise conv1d of width W, then SiLU. u (B, S, C); conv_state
    (B, W-1, C), the last W-1 inputs before u. As the reference, the state
    is cast to u's dtype before use, so on the bf16 path an fp32 state
    leaf holds bf16-rounded values; the taps accumulate in u's dtype.
    Returns (y, new_state), new_state in u's dtype."""
    W = w.shape[0]
    full = torch.cat([conv_state.to(u.dtype), u], dim=1)
    S = u.shape[1]
    ys = None
    for wi in range(W):
        tap = full[:, wi:wi + S] * w[wi]
        ys = tap if ys is None else ys + tap
    y = _silu(ys + b.to(u.dtype))
    new_state = full[:, -(W - 1):] if W > 1 else conv_state
    return y, new_state


def mamba2_scan_chunked(x, dt, A, B, C, s0, chunk: int = MAMBA2_CHUNK):
    """The recurrence of ``ref.mamba2_scan_ref`` in the chunked SSD form,
    fp32, the same arguments and results. Within a chunk of L steps, with
    log a_i = dt_i A, cum_t = sum_{i <= t} log a_i and the segment sums
    seg_tj = sum_{j < i <= t} log a_i:

      y_t = sum_{j <= t} exp(seg_tj) (C_t . B_j) dt_j x_j + exp(cum_t) (s_in . C_t)
      s_out = exp(cum_{L-1}) s_in + sum_j exp(seg_{L-1,j}) dt_j x_j (x) B_j

    Every exponent is a sum of dt A <= 0: the pairs j > t are masked to
    -inf before the exp, and exp(-cum) or exp(+cum) is never formed alone
    (the reference's chunked rwkv6 form overflows that way, ROADMAP C12).
    seg is summed from j + 1 on, not taken as cum_t - cum_j, whose
    cancellation would cost a short segment the bits of a long prefix.
    The intra-chunk products and the chunks' own states are batched over
    all chunks; only the pass that carries the state from chunk to chunk
    is a loop. A length that is no multiple of ``chunk`` is padded with
    dt = 0 (a = 1, no input), which leaves the state unchanged."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    f32 = torch.float32
    x, dt, B, C = (t.to(f32) for t in (x, dt, B, C))
    s = s0.to(f32)
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        x, dt, B, C = (torch.cat([t, t.new_zeros((Bt, pad) + t.shape[2:])], dim=1)
                       for t in (x, dt, B, C))
    x = x.reshape(Bt, nc, L, H, P)
    dt = dt.reshape(Bt, nc, L, H)
    B = B.reshape(Bt, nc, L, N)
    C = C.reshape(Bt, nc, L, N)
    la = (dt * A.to(f32)).transpose(2, 3)  # (Bt, nc, H, L): log a_t <= 0
    # seg[t, j] = sum_{j < i <= t} log a_i, summed from j + 1 on (not
    # cum_t - cum_j, which loses the short segments' bits to cancellation)
    pairs = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()  # j <= t
    seg = torch.cumsum(la[..., :, None].expand(*la.shape, L).masked_fill(~pairs.tril(-1), 0.0),
                       dim=-2)
    decay = torch.exp(seg.masked_fill(~pairs, float("-inf")))  # (Bt, nc, H, L, L)
    cum = torch.cumsum(la, dim=-1)  # (Bt, nc, H, L): log of a_0 ... a_t
    cb = torch.einsum("bctn,bcjn->bctj", C, B)  # (Bt, nc, L, L)
    dtx = dt[..., None] * x  # (Bt, nc, L, H, P)
    y = torch.einsum("bchtj,bcjhp->bcthp", decay * cb[:, :, None], dtx)
    # each chunk's own end state from zero (row L - 1 of the decay: exp of
    # log a_{j+1} + ... + log a_{L-1}), then the pass over the chunks
    to_end = decay[..., -1, :].transpose(2, 3)  # (Bt, nc, L, H)
    own = torch.einsum("bcjhp,bcjn->bchpn", to_end[..., None] * dtx, B)
    total = torch.exp(cum[..., -1])  # (Bt, nc, H)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = total[:, c, :, None, None] * s + own[:, c]
    s_in = torch.stack(s_in, 1)  # (Bt, nc, H, P, N)
    y = y + torch.exp(cum).transpose(2, 3)[..., None] * torch.einsum(
        "bchpn,bctn->bcthp", s_in, C)
    return y.reshape(Bt, nc * L, H, P)[:, :S], s


def mamba2_block(cfg, p, x, state):
    """Mamba2 mixer on x (B, S, d): the projections, the two causal convs,
    dt = softplus(x wdt + dt_bias), the scan (exact at S = 1, chunked
    beyond), the D skip, y cast to x's dtype before the SiLU gate, the
    gated RMSNorm ((1 + norm_scale)) and ``out_proj``. Returns (y,
    new_state), the state leaves in ``state``'s dtypes."""
    Bt, S, _ = x.shape
    din, H, N, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    z = mm(x, p["wz"])
    xin = mm(x, p["wx"])
    BC = torch.cat([mm(x, p["wB"]), mm(x, p["wC"])], dim=-1)
    dt = mm(x, p["wdt"])  # (B, S, H)
    xin, conv_x = _causal_conv(p["conv_x"], p["conv_b_x"], xin, state["conv_x"])
    BC, conv_bc = _causal_conv(p["conv_BC"], p["conv_b_BC"], BC, state["conv_BC"])
    f32 = torch.float32
    Bc, Cc = BC[..., :N].to(f32), BC[..., N:].to(f32)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])  # (H,) negative
    xh = xin.reshape(Bt, S, H, P).to(f32)
    scan = R.mamba2_scan_ref if S == 1 else mamba2_scan_chunked
    s0 = state["s"].to(f32)
    mesh = ops.mesh_of(xh, dt, Bc, Cc, s0)
    if mesh is not None:
        # each device scans its (batch, head) shards, as a kernel op does:
        # B and C are shared by the heads, A by the batch
        px = ops.shard_layout(mesh, batch_dim=0, batch=Bt, head_dim=2, heads=(H,))
        pb = ops.shard_layout(mesh, batch_dim=0, batch=Bt)
        y, s_new = ops.on_shards(scan, mesh, [
            (xh, px), (dt, px), (A, ops.shard_layout(mesh, head_dim=0, heads=(H,))),
            (Bc, pb), (Cc, pb),
            (s0, ops.shard_layout(mesh, batch_dim=0, batch=Bt, head_dim=1, heads=(H,)))],
            (px, ops.shard_layout(mesh, batch_dim=0, batch=Bt, head_dim=1, heads=(H,))))
    else:
        y, s_new = scan(xh, dt, A, Bc, Cc, s0)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(Bt, S, din).to(x.dtype)
    y = y * _silu(z)
    y = rmsnorm(y, p["norm_scale"])
    y = mm(y, p["out_proj"])
    return y, {"conv_x": conv_x.to(state["conv_x"].dtype),
               "conv_BC": conv_bc.to(state["conv_BC"].dtype), "s": s_new}


def init_mamba2_state(cfg, batch: int, dtype=torch.float32, device=None):
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    W = cfg.conv_width
    return {
        "conv_x": torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype, device=device),
        "conv_BC": torch.zeros((batch, W - 1, 2 * N), dtype=dtype, device=device),
        "s": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }
