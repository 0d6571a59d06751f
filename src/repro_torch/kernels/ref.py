"""Plain PyTorch versions of the port's kernels: the CPU execution path and
the reference the CUDA kernels are held to on the card. Counterpart of
``repro.kernels.ref``; each function mirrors its reference's signature and
also takes stacked leading axes, so the batched versions are the same
functions."""
from __future__ import annotations

import torch


# --- skr_rectify -----------------------------------------------------------


def skr_rectify_rows_ref(probs, labels, p_c, do, qb):
    """Eq. (31) from per-row values: probs (..., C); labels, p_c, do, qb
    (...). The expression order matches the TPU kernel's
    (``repro/kernels/skr_rectify.py:_kernel``)."""
    scale = (1.0 - qb) / torch.clamp_min(1.0 - p_c, 1e-12)
    rect = probs * scale[..., None]
    is_label = labels.long()[..., None] == torch.arange(probs.shape[-1],
                                                        device=probs.device)
    rect = torch.where(is_label, qb[..., None], rect)
    return torch.where(do[..., None], rect, probs)


def skr_rectify_ref(probs, labels, qbar, counts):
    """Batched Eq. (31) with precomputed queue means: probs (N, C), labels
    (N,), qbar/counts (C,) — or stacked (B, N, C), (B, N), (B, C)."""
    labels = labels.long()
    p_c = probs.gather(-1, labels[..., None])[..., 0]
    mis = probs.argmax(-1) != labels  # Eq. 8
    do = mis & (counts.gather(-1, labels) > 0)
    qb = qbar.gather(-1, labels)
    return skr_rectify_rows_ref(probs, labels, p_c, do, qb)


skr_rectify_batched_ref = skr_rectify_ref


def skr_process_ref(probs, labels, q, count, head):
    """SKR's Algorithm 2 for one pair, as ``repro.core.skr.skr_process_batch``
    computes it: a sequential queue pass over the rows (later rows of a
    class see the pushes of earlier rows), then Eq. (31) on every row.
    probs (N, C) fp32; labels (N,); q (C, Bq) fp32; count, head (C,) int32.
    Returns (Q, q, count, head), the state in new tensors."""
    C, Bq = q.shape
    N = labels.shape[0]
    dev = probs.device
    labels = labels.long()
    cls = torch.arange(C, device=dev)
    slot = torch.arange(Bq, device=dev)
    p_c = probs.gather(1, labels[:, None])[:, 0]
    correct = probs.argmax(dim=1) == labels
    seen_cnt = count.new_zeros(N)
    seen_qbar = q.new_zeros(N)
    q, count, head = q.clone(), count.clone(), head.clone()
    for i in range(N):
        c = labels[i:i + 1]
        cnt = count.gather(0, c)
        hd = head.gather(0, c)
        qrow = q.index_select(0, c)[0]
        seen_cnt[i:i + 1] = cnt
        seen_qbar[i:i + 1] = torch.sum(qrow * (slot < cnt)) / torch.clamp_min(cnt, 1)
        # push on correct attribution
        push = (cls == c) & correct[i]
        q = torch.where(push[:, None] & (slot == hd)[None, :], p_c[i], q)
        head = torch.where(push, (hd + 1) % Bq, head)
        count = torch.where(push, torch.clamp_max(cnt + 1, Bq), count)
    do = ~correct & (seen_cnt > 0)
    return skr_rectify_rows_ref(probs, labels, p_c, do, seen_qbar), q, count, head


def skr_process_batched_ref(probs, labels, q, count, head):
    """``skr_process_ref`` for B independent pairs: probs (B, N, C), labels
    (B, N), q (B, C, Bq), count and head (B, C)."""
    if probs.shape[0] == 0:
        return probs.clone(), q.clone(), count.clone(), head.clone()
    pairs = [skr_process_ref(*a) for a in zip(probs, labels, q, count, head)]
    return tuple(torch.stack(x) for x in zip(*pairs))


# --- distill loss (fused CE + beta*KL over the vocab axis) ------------------


def distill_loss_ref(logits, labels, teacher_logprobs, beta, label_weight=1.0):
    """Per-row: CE(softmax(z), y) + beta * KL(softmax(z) || exp(tlq)).

    logits: (..., V) student logits; labels (...) int; teacher_logprobs:
    (..., V) log of the (possibly rectified) teacher probs, in logits'
    dtype. Both are read as fp32, as the TPU kernel reads them. Returns fp32
    per-row losses (...).
    """
    logits = logits.to(torch.float32)
    teacher_logprobs = teacher_logprobs.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    logp = logits - logz
    ce = -logp.gather(-1, labels.long()[..., None])[..., 0]
    sp = torch.exp(logp)
    kl = torch.sum(sp * (logp - teacher_logprobs), dim=-1)
    return label_weight * ce + beta * kl


def distill_loss_grad_ref(logits, labels, teacher_logprobs, beta,
                          label_weight=1.0, *, g=None):
    """d(per-row loss)/d logits, times the per-row cotangent ``g`` (...)
    when given — the reference for the backward kernel. Computed in fp32 and
    rounded once to logits' dtype, as the TPU kernel writes dz."""
    dtype = logits.dtype
    logits = logits.to(torch.float32)
    teacher_logprobs = teacher_logprobs.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    logp = logits - logz
    sp = torch.exp(logp)
    onehot = (labels.long()[..., None] == torch.arange(
        logits.shape[-1], device=logits.device)).to(torch.float32)
    kl = torch.sum(sp * (logp - teacher_logprobs), dim=-1, keepdim=True)
    dce = sp - onehot
    dkl = sp * ((logp - teacher_logprobs) - kl)
    dz = label_weight * dce + beta * dkl
    if g is not None:
        dz = g.to(torch.float32)[..., None] * dz
    return dz.to(dtype)


distill_loss_batched_ref = distill_loss_ref


@torch.no_grad()
def distill_loss_grad_bf16_bound(want, logits, teacher_logprobs, beta, *, g=None):
    """How far a bf16 dz may lie from ``want`` (the plain version's dz) when
    both were computed in fp32 and rounded once: one bf16 ulp of |want|
    (2^-7 |want|), and nothing more at beta = 0, where dz = g lw (p - onehot)
    and no two terms cancel. At beta > 0, beta's term can cancel lw p, and
    the bracket (logp - t) - KL then carries the fp32 errors of logZ and KL
    (sums over V in other orders), which the bound allows as 2^-16 of the
    terms they come from: g beta p (|logZ| + |logp - t| + |KL|) per element.
    Returns an fp32 tensor of want's shape."""
    bound = 2.0**-7 * want.to(torch.float32).abs()
    if not beta:
        return bound
    z = logits.to(torch.float32)
    t = teacher_logprobs.to(torch.float32)
    logz = torch.logsumexp(z, dim=-1, keepdim=True)
    logp = z - logz
    sp = torch.exp(logp)
    kl = torch.sum(sp * (logp - t), dim=-1, keepdim=True)
    slack = 2.0**-16 * beta * sp * (logz.abs() + (logp - t).abs() + kl.abs())
    if g is not None:
        slack = g.to(torch.float32).abs()[..., None] * slack
    return bound + slack


def softmax_xent_ref(logits, labels, label_weight=1.0):
    """Plain lw * CE per row (the beta=0 special case used for the LM loss):
    the CE entry's forward, with no teacher. fp32 per-row losses (...)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return label_weight * (logz - gold)


def softmax_xent_grad_ref(logits, labels, label_weight=1.0, *, g=None):
    """d(lw * CE per row)/d logits, times the per-row cotangent ``g`` when
    given: the CE entry's backward. Computed in fp32 and rounded once to
    logits' dtype."""
    dtype = logits.dtype
    logits = logits.to(torch.float32)
    sp = torch.exp(logits - torch.logsumexp(logits, dim=-1, keepdim=True))
    onehot = (labels.long()[..., None] == torch.arange(
        logits.shape[-1], device=logits.device)).to(torch.float32)
    dz = label_weight * (sp - onehot)
    if g is not None:
        dz = g.to(torch.float32)[..., None] * dz
    return dz.to(dtype)


# --- flash attention ---------------------------------------------------------


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """q (B,Sq,N,H), k (B,Sk,K,H), v (B,Sk,K,Hv); the output (B,Sq,N,Hv).
    GQA; absolute-position masks; the scale is H^-0.5 of q's head_dim. The
    (B, K, G, Sq, Sk) fp32 scores are materialised."""
    B, Sq, N, H = q.shape
    K = k.shape[2]
    G = N // K
    qf = q.to(torch.float32) * (H**-0.5)
    qf = qf.reshape(B, Sq, K, G, H)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(torch.float32))
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    m = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= kpos[None, :] > (qpos[:, None] - window)
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, N, v.shape[-1]).to(q.dtype)


def latent_decode_ref(q, c_kv, k_rope, *, scale, q_offset):
    """MLA's absorbed decode over the compressed cache, one query a
    sequence at position ``q_offset``, as the reference computes it in jnp
    (``repro.models.attention.mla_forward``'s decode branch):

      ctx[b, n] = softmax_j(scale (q[b, n, :L] . c_kv[b, j] + q[b, n, L:] . k_rope[b, j])) c_kv[b, j]

    over j <= q_offset (every cache row once q_offset >= S). q (B, 1, N,
    L + R) fp32 (``q_lat`` joined to ``q_rope``); c_kv (B, S, L) and k_rope
    (B, S, R) in the cache's dtype, read as fp32. Returns ctx (B, 1, N, L),
    fp32."""
    L = c_kv.shape[-1]
    qf = q.to(torch.float32)
    ckv = c_kv.to(torch.float32)
    s_nope = torch.einsum("bqnl,bsl->bnqs", qf[..., :L], ckv)
    s_rope = torch.einsum("bqnd,bsd->bnqs", qf[..., L:], k_rope.to(torch.float32))
    s = (s_nope + s_rope) * scale
    valid = torch.arange(c_kv.shape[1], device=q.device) <= q_offset
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnqs,bsl->bqnl", p, ckv)


# --- mamba2 scan -------------------------------------------------------------


def mamba2_scan_ref(x, dt, A, B, C, s0, dtype=torch.float32):
    """Exact Mamba2 (SSD) recurrence, step for step as the reference's
    ``lax.scan`` in ``repro.models.ssm.mamba2_block``:

      a_t = exp(dt_t A);  s <- a_t s + (dt_t x_t) (x) B_t;  y_t = s . C_t

    x (Bt, S, H, P), dt (Bt, S, H), A (H,) (negative rates), B and C
    (Bt, S, N), s0 (Bt, H, P, N). Returns (y (Bt, S, H, P), sT), computed
    in ``dtype``; y has no D x skip term. The reference has no Pallas
    kernel here (its scan is XLA's), so this is the plain version the
    chunked form (``models.ssm.mamba2_scan_chunked``) is held to, and the
    one decode runs (S = 1)."""
    x, dt, A, B, C = (t.to(dtype) for t in (x, dt, A, B, C))
    a = torch.exp(dt * A)
    s = s0.to(dtype)
    ys = []
    for t in range(x.shape[1]):
        s = (a[:, t, :, None, None] * s
             + (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, t]))
    y = torch.stack(ys, 1) if ys else x.new_zeros(x.shape)
    return y, s


# --- rwkv6 scan --------------------------------------------------------------


def rwkv6_scan_ref(r, k, v, w, u, s0, dtype=torch.float32):
    """Exact RWKV6 recurrence. r/k/v/w: (B,T,H,hd) fp32, u: (H,hd),
    s0: (B,H,hd,hd). Returns (y (B,T,H,hd), sT), computed in ``dtype``
    (fp64 is the yardstick the fp32 forms are held to, ROADMAP C13)."""
    r, k, v, w, u = (t.to(dtype) for t in (r, k, v, w, u))
    s = s0.to(dtype)
    uu = u[None, ..., None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.stack(ys, 1) if ys else r.new_zeros(r.shape)
    return y, s


def rwkv6_scan_chunked_ref(r, k, v, w, u, s0, chunk):
    """``rwkv6_scan_ref`` by the chunked state-passing form that
    ``csrc/rwkv6_scan_chunked.cu`` computes, phase by phase (for the tests;
    the op never runs it):

    1. each chunk of ``chunk`` steps from a zero state: y_local_t = r_t ·
       S_local + (r_t · (u ⊙ k_t)) v_t; r_t ⊙ P_t, with P_t the product of
       w since the chunk began (plain fp32 products: finite for any w in
       [0, 1]); the chunk's end state dS and full product P_end;
    2. the entry state of each chunk, S ← diag(P_end) S + dS from s0;
    3. y_t += (r_t ⊙ P_t) · S_entry.
    """
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    uu = u.to(torch.float32)
    s = s0.to(torch.float32)
    T = r.shape[1]
    y, rp = torch.empty_like(r), torch.empty_like(r)
    bounds = [(c0, min(T, c0 + chunk)) for c0 in range(0, T, chunk)]
    ends = []
    for c0, c1 in bounds:
        sl = torch.zeros_like(s)
        p = torch.ones_like(w[:, 0])
        for t in range(c0, c1):
            a = (r[:, t] * uu * k[:, t]).sum(-1, keepdim=True)
            y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t], sl) + a * v[:, t]
            sl = w[:, t, :, :, None] * sl + k[:, t, :, :, None] * v[:, t, :, None, :]
            rp[:, t] = r[:, t] * p
            p = p * w[:, t]
        ends.append((sl, p))
    entries = []
    for ds, p_end in ends:
        entries.append(s)
        s = p_end[..., None] * s + ds
    for (c0, c1), se in zip(bounds, entries):
        y[:, c0:c1] += torch.einsum("bthi,bhij->bthj", rp[:, c0:c1], se)
    return y, s


def _rwkv6_step_grads(sp, g, r, k, v, dy, u):
    """One step's (dr, dk, dv, dw, du) from S_{t-1} ``sp`` and G_t ``g``
    (B, H, hd, hd), the step's r, k, v, dy (B, H, hd) and u (H, hd)."""
    b = (v * dy).sum(-1, keepdim=True)
    a = (r * u * k).sum(-1, keepdim=True)
    dr = torch.einsum("bhij,bhj->bhi", sp, dy) + u * k * b
    dk = torch.einsum("bhij,bhj->bhi", g, v) + u * r * b
    dv = torch.einsum("bhij,bhi->bhj", g, k) + a * dy
    dw = (g * sp).sum(-1)
    return dr, dk, dv, dw, (r * k * b).sum(0)


def rwkv6_scan_grad_ref(r, k, v, w, u, s0, dy, dsT):
    """The gradient of ``rwkv6_scan_ref``: (dr, dk, dv, dw, du, ds0) for the
    cotangents dy (B, T, H, hd) of y and dsT (B, H, hd, hd) of the final
    state, all fp32, by the reverse-time equations. S_{t-1} is the state
    before step t (S_{-1} = s0) and G_t the cotangent of S_t:

        G_{T-1} = dsT,  G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ,  ds0 = G_{-1};
        b_t = v_t · dy_t,  a_t = Σ_i r_t[i] u[i] k_t[i];
        dr_t = S_{t-1} dy_t + u ⊙ k_t b_t,   dk_t = G_t v_t + u ⊙ r_t b_t,
        dv_t = G_tᵀ k_t + a_t dy_t,          dw_t[i] = Σ_j G_t[i,j] S_{t-1}[i,j],
        du = Σ_{b,t} r_t ⊙ k_t b_t.

    dw comes from G_t and S_{t-1} directly, never by dividing by w, so a
    decay of 0 or 1e-30 gives a finite, exact gradient. The states S_{t-1}
    are kept from a forward pass (T of them)."""
    r, k, v, w, dy = (t.to(torch.float32) for t in (r, k, v, w, dy))
    uf = u.to(torch.float32)
    s = s0.to(torch.float32)
    states = []
    for t in range(r.shape[1]):
        states.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    g = dsT.to(torch.float32)
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(r.shape[1])):
        dr[:, t], dk[:, t], dv[:, t], dw[:, t], du_t = _rwkv6_step_grads(
            states[t], g, r[:, t], k[:, t], v[:, t], dy[:, t], uf)
        du = du + du_t
        g = w[:, t, :, :, None] * g + r[:, t, :, :, None] * dy[:, t, :, None, :]
    return dr, dk, dv, dw, du, g


def _decay_factors(w):
    """Per step t of w (B, n, H, hd): Pin_t = ∏_{τ<t} w_τ and Qout_t =
    ∏_{τ>t} w_τ, running products (no ratio, log or exp), and their full
    product P_end."""
    n = w.shape[1]
    pin, qout = torch.ones_like(w), torch.ones_like(w)
    for t in range(1, n):
        pin[:, t] = pin[:, t - 1] * w[:, t - 1]
    for t in reversed(range(n - 1)):
        qout[:, t] = qout[:, t + 1] * w[:, t + 1]
    return pin, qout, pin[:, -1] * w[:, -1]


def rwkv6_scan_grad_chunked_ref(r, k, v, w, u, s0, dy, dsT, chunk, sub):
    """``rwkv6_scan_grad_ref`` by the chunked matrix form that
    ``csrc/rwkv6_scan_bwd.cu`` computes, phase by phase (for the tests; the
    op never runs it): chunks of ``chunk`` steps hold the states, sub-chunks
    of ``sub`` steps (``sub`` divides ``chunk``) the decayed parts. Per
    (b, h) and per (sub-)chunk, Pin_t = ∏_{τ<t} w_τ, Qout_t = ∏_{τ>t} w_τ
    and D_{s,t} = ∏_{s<τ<t} w_τ within it, each a running product: nothing
    divides by w, so a decay of 0, 1e-30 or 1 gives exact gradients.

    1. per chunk, the products dS_c = (K ⊙ Qout)ᵀ V and dG_c = (R ⊙ Pin)ᵀ DY
       and P_end;
    2. the entry state of each chunk, S ← diag(P_end) S + dS_c from s0, and
       its exit cotangent (the cotangent of its last state), G ←
       diag(P_end) G + dG_c from dsT in reverse; the last G is ds0;
    3. per chunk, its sub-chunks in reverse with G carried from the chunk's
       exit cotangent (G ← diag(P_end) G + (R ⊙ Pin)ᵀ DY after each), and
       each sub-chunk's entry state S⁰ = diag(Pin_b) S_entry + (K ⊙ D_{·,b})ᵀ
       V over the chunk's steps before it (b its first step); then the
       products X = DY S⁰ᵀ, Y = V Gᵀ, Zv = (K ⊙ Qout) G and M1 = DY Vᵀ and
       c0 = rowsum(S⁰ ⊙ G);
    4. per sub-chunk, the decayed parts, steps t in reverse: with Gv (rows
       G v_s, from Y) and Xg (rowsum(S⁰ ⊙ G), from c0) at G_t,
       dr_t = Pin_t ⊙ X_t + Σ_{s<t} D_{s,t} ⊙ k_s M1[t,s] + u ⊙ k_t b_t,
       dk_t = Gv[t] + u ⊙ r_t b_t,  dw_t = Pin_t ⊙ Xg + Σ_{s<t} D_{s,t} ⊙ k_s
       ⊙ Gv[s],  A[t,s] = Σ_i r_t D_{s,t} k_s (A[t,t] = a_t), then Gv[s] ←
       w_t ⊙ Gv[s] + r_t M1[t,s] and Xg ← w_t ⊙ Xg + r_t ⊙ X_t; and dv = Zv
       + Aᵀ DY. du as per-chunk partial sums, summed last.

    The products of steps 1 and 3 (and Aᵀ DY) are the kernel's tensor-core
    GEMMs; step 4's loops its fp32 part."""
    if chunk % sub:
        raise ValueError(f"sub ({sub}) must divide chunk ({chunk})")
    r, k, v, w, dy = (t.to(torch.float32) for t in (r, k, v, w, dy))
    uf = u.to(torch.float32)
    T = r.shape[1]
    bounds = [(c0, min(T, c0 + chunk)) for c0 in range(0, T, chunk)]
    local = []
    for c0, c1 in bounds:
        pin, qout, p_end = _decay_factors(w[:, c0:c1])
        ds = torch.einsum("bthi,bthj->bhij", k[:, c0:c1] * qout, v[:, c0:c1])
        dg = torch.einsum("bthi,bthj->bhij", r[:, c0:c1] * pin, dy[:, c0:c1])
        local.append((ds, dg, p_end))
    s, entries = s0.to(torch.float32), []
    for ds, _, p_end in local:
        entries.append(s)
        s = p_end[..., None] * s + ds
    g, exits = dsT.to(torch.float32), [None] * len(bounds)
    for c in reversed(range(len(bounds))):
        exits[c] = g
        g = local[c][2][..., None] * g + local[c][1]
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du_parts = []
    for (c0, c1), se, gc in zip(bounds, entries, exits):
        gq, du_c = gc, torch.zeros_like(uf)
        for b0 in reversed(range(c0, c1, sub)):
            b1 = min(c1, b0 + sub)
            # the sub-chunk's entry state, directly from the chunk's
            pin_b, kd = torch.ones_like(w[:, 0]), torch.zeros_like(k[:, c0:b0])
            for s_ in reversed(range(c0, b0)):
                kd[:, s_ - c0] = k[:, s_] * pin_b
                pin_b = pin_b * w[:, s_]
            sq = pin_b[..., None] * se + torch.einsum("bthi,bthj->bhij", kd, v[:, c0:b0])
            rq, kq, vq, wq, yq = (a[:, b0:b1] for a in (r, k, v, w, dy))
            pin, qout, p_end = _decay_factors(wq)
            x = torch.einsum("bthj,bhij->bthi", yq, sq)
            gv = torch.einsum("bthj,bhij->bthi", vq, gq)
            zv = torch.einsum("bthi,bhij->bthj", kq * qout, gq)
            m1 = torch.einsum("bthj,bshj->bhts", yq, vq)
            xg = (sq * gq).sum(-1)
            n = b1 - b0
            a = torch.zeros(m1.shape, dtype=torch.float32)
            for t in reversed(range(n)):
                rt, kt, wt, mt = rq[:, t], kq[:, t], wq[:, t], m1[:, :, t]
                bt = mt[:, :, t, None]
                d, acc_r, acc_w = torch.ones_like(wt), torch.zeros_like(wt), torch.zeros_like(wt)
                for s_ in reversed(range(t)):
                    kdd = kq[:, s_] * d
                    acc_r = acc_r + kdd * mt[:, :, s_, None]
                    acc_w = acc_w + kdd * gv[:, s_]
                    a[:, :, t, s_] = (rt * kdd).sum(-1)
                    gv[:, s_] = wt * gv[:, s_] + rt * mt[:, :, s_, None]
                    d = d * wq[:, s_]
                a[:, :, t, t] = (rt * uf * kt).sum(-1)
                dr[:, b0 + t] = d * x[:, t] + acc_r + uf * kt * bt
                dk[:, b0 + t] = gv[:, t] + uf * rt * bt
                dw[:, b0 + t] = d * xg + acc_w
                du_c = du_c + (rt * kt * bt).sum(0)
                xg = wt * xg + rt * x[:, t]
            dv[:, b0:b1] = zv + torch.einsum("bhts,bthj->bshj", a, yq)
            gq = p_end[..., None] * gq + torch.einsum("bthi,bthj->bhij", rq * pin, yq)
        du_parts.append(du_c)
    du = torch.stack(du_parts).sum(0) if du_parts else torch.zeros_like(uf)
    return dr, dk, dv, dw, du, g
