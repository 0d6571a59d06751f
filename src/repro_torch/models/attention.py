"""Attention: GQA (full / sliding-window / causal, chunked online-softmax)
with a KV cache, cross attention (whisper's decoder over the encoder's
states), and MLA (DeepSeek multi-head latent attention, with an absorbed
decode path).

Counterpart of ``repro.models.attention``.

Conventions
-----------
* q/k/v layout: (batch, seq, heads, head_dim).
* KV caches: dict(k=(B, S, K, H), v=(B, S, K, H)) — or for MLA,
  dict(c_kv=(B, S, lora), k_rope=(B, S, rope_dim)), two views of one (B,
  S, lora + rope_dim) buffer (``init_mla_cache``).
* ``mha`` is the reference's jnp attention in torch ops (einsum, softmax),
  differentiated by autograd, as the reference's is by XLA. It is the
  training path: ``attn_forward(train=True)``, which ``forward_train``
  asks for through ``apply_block``.
* Prefill and decode (``train=False``) compute attention with
  ``ops.flash_attention``: the hand-written kernel on the card, its plain
  version (``kernels.ref.flash_attention_ref``) on the CPU. The kernels
  have no backward (nor have the TPU kernels), and their wrappers raise on
  the card if an input requires grad.
* Cross attention is non-causal over all of the encoder's states, by
  ``ops.flash_attention(causal=False)`` at prefill and decode and by
  ``mha(causal=False)`` under ``train``. As the reference, it caches
  nothing: k and v are projected from the encoder's states at every call,
  each decode step included.
* MLA's prefill runs the expanded form (q and k 192 wide, v 128 at
  deepseek-v2-lite-16b's dims) through ``ops.flash_attention``, its
  training the same form through ``mha``; its decode the absorbed form
  through ``ops.latent_decode``, over the compressed cache in place, with
  q_lat = q_nope W_uk and ctx W_uv in fp32 as the reference computes them
  (library products: the reference's are jnp einsums).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    mm,
    rmsnorm,
    rope_angles,
    split_heads,
    write_seq,
)


def init_attn(gen: torch.Generator, cfg, dtype, kv_mult: int = 1):
    d, n, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    kv = cfg.num_kv_heads * kv_mult
    p = {
        "wq": dense_init(gen, d, n * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, n * hd, d, dtype, scale=(n * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=gen.device)
    return p


def _split_heads(x, n, hd):
    return split_heads(x, n, hd)


NEG_INF = -1e30


def mha(q, k, v, *, q_positions, k_positions, causal: bool = True, window: int = 0,
        chunk: int = 0, valid_len=None):
    """Grouped-query attention with absolute-position masking.

    q: (B, Sq, N, H); k/v: (B, Sk, K, Hv). N % K == 0. Scores, softmax and
    output are fp32; the result has q's dtype.
    window > 0 limits attention to the trailing `window` positions.
    chunk > 0 (and Sk > chunk) runs an online softmax over KV chunks of
    ``chunk`` keys (Sk % chunk == 0), the reference's ``lax.scan`` as a loop.
    valid_len: optional scalar — kv positions >= valid_len are masked.
    DTensors run on each device's (batch, head) shards
    (``ops.attention_on_shards``).
    """
    if ops.mesh_of(q, k, v) is not None:
        return ops.attention_on_shards(
            lambda q, k, v: mha(q, k, v, q_positions=q_positions, k_positions=k_positions,
                                causal=causal, window=window, chunk=chunk,
                                valid_len=valid_len), q, k, v)
    B, Sq, N, H = q.shape
    K = k.shape[2]
    G = N // K
    scale = H**-0.5
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, K, G, H)

    def mask_for(kpos):
        # (Sq, Ck) boolean validity mask from absolute positions
        m = torch.ones((Sq, kpos.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            m &= q_positions[:, None] >= kpos[None, :]
        if window:
            m &= kpos[None, :] > (q_positions[:, None] - window)
        if valid_len is not None:
            m &= kpos[None, :] < valid_len
        return m

    if not chunk or k.shape[1] <= chunk:
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(torch.float32))
        s = torch.where(mask_for(k_positions), s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
        return o.reshape(B, Sq, N, v.shape[-1]).to(q.dtype)

    # --- online softmax over KV chunks (flash-style) ---------------------
    Sk = k.shape[1]
    assert Sk % chunk == 0, (Sk, chunk)
    m_i = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_i = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, v.shape[-1]), dtype=torch.float32, device=q.device)
    for c in range(Sk // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, k[:, sl].to(torch.float32))
        s = torch.where(mask_for(k_positions[sl]), s, NEG_INF)
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        alpha = torch.exp(m_i - m_new)
        p = torch.exp(s - m_new[..., None])
        l_i = l_i * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p, v[:, sl].to(torch.float32))
        m_i = m_new
    o = acc / torch.clamp_min(l_i, 1e-30)[..., None]
    o = o.reshape(B, K * G, Sq, -1).transpose(1, 2)
    return o.to(q.dtype)


def attn_forward(cfg, params, x, *, positions, theta: float, window: int = 0,
                 cache: Optional[dict] = None, cache_pos: Optional[int] = None,
                 chunk: int = 0, kv_mult: int = 1, return_kv: bool = False,
                 train: bool = False):
    """Self-attention forward.

    Modes:
      * train/prefill: cache is None; full-sequence causal attention, by
        ``mha`` (with ``chunk``) when ``train``, else by
        ``ops.flash_attention``. return_kv=True additionally returns the
        (k, v) to seed a cache.
      * decode: cache holds (B, S, K, H); x is (B, 1, d); cache_pos is the
        write/attend position, a Python int, so nothing is read back from
        the card. The new k/v are written into the cache in place (the same
        values, at the same clamped slot, as the reference's
        ``dynamic_update_slice``), and the returned cache is the same dict.
    """
    B, S, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    kv_heads = cfg.num_kv_heads * kv_mult

    q = _split_heads(mm(x, params["wq"]), n, hd)
    k = _split_heads(mm(x, params["wk"]), kv_heads, hd)
    v = _split_heads(mm(x, params["wv"]), kv_heads, hd)

    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])

    sin, cos = rope_angles(positions, hd, theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if cache is None:
        if train:
            o = mha(q, k, v, q_positions=positions, k_positions=positions, causal=True,
                    window=window, chunk=chunk)
        else:
            o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=True, window=window, q_offset=0)
        y = mm(o.reshape(B, S, n * hd), params["wo"])
        if return_kv:
            return y, {"k": k, "v": v}
        return y, None

    # decode: single new token at cache_pos. The write lands where the
    # reference's dynamic_update_slice clamps it (the last slot once
    # cache_pos runs past the cache); the causal mask at q_offset =
    # cache_pos is its valid_len = cache_pos + 1
    at = max(0, min(cache_pos, cache["k"].shape[1] - S))
    write_seq(cache["k"], at, k.to(cache["k"].dtype))
    write_seq(cache["v"], at, v.to(cache["v"].dtype))
    # attend in the wider of q's and the cache's dtypes, as the reference
    # computes in fp32 whatever the cache holds
    dt = torch.promote_types(q.dtype, cache["k"].dtype)
    o = ops.flash_attention(q.to(dt).contiguous(), cache["k"].to(dt), cache["v"].to(dt),
                            causal=True, window=window, q_offset=cache_pos)
    y = mm(o.reshape(B, S, n * hd).to(x.dtype), params["wo"])
    return y, cache


def init_kv_cache(cfg, batch: int, seq: int, dtype, kv_mult: int = 1, device=None):
    kv = cfg.num_kv_heads * kv_mult
    shape = (batch, seq, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------


def init_cross_attn(gen: torch.Generator, cfg, dtype):
    d, n, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, n * hd, dtype),
        "wk": dense_init(gen, d, n * hd, dtype),
        "wv": dense_init(gen, d, n * hd, dtype),
        "wo": dense_init(gen, n * hd, d, dtype, scale=(n * hd) ** -0.5),
    }


def cross_attn_forward(cfg, params, x, enc_out, *, train: bool = False):
    """x: (B, S, d) decoder states; enc_out: (B, Se, d) encoder states.
    Every query sees every encoder state. q, k and v have the dtypes
    ``mm``'s promotion gives (a bf16 ``enc_out`` against an fp32 model
    projects in fp32, as jnp does); attention runs in the wider of q's and
    k's, and its output has q's dtype, as the reference's ``mha`` gives."""
    B, S, _ = x.shape
    n, hd = cfg.num_heads, cfg.head_dim
    q = _split_heads(mm(x, params["wq"]), n, hd)
    k = _split_heads(mm(enc_out, params["wk"]), n, hd)
    v = _split_heads(mm(enc_out, params["wv"]), n, hd)
    if train:
        o = mha(q, k, v, q_positions=torch.arange(S, device=x.device),
                k_positions=torch.arange(enc_out.shape[1], device=x.device), causal=False)
    else:
        dt = torch.promote_types(q.dtype, k.dtype)
        o = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), causal=False,
                                q_offset=0).to(q.dtype)
    return mm(o.reshape(B, S, n * hd), params["wo"])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg, dtype):
    d, n = cfg.d_model, cfg.num_heads
    nope, rope_d, vd, lora = (
        cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank,
    )
    return {
        "wq": dense_init(gen, d, n * (nope + rope_d), dtype),
        "w_dkv": dense_init(gen, d, lora + rope_d, dtype),
        "kv_norm": torch.zeros((lora,), dtype=torch.float32, device=gen.device),
        "w_uk": dense_init(gen, lora, n * nope, dtype),
        "w_uv": dense_init(gen, lora, n * vd, dtype),
        "wo": dense_init(gen, n * vd, d, dtype, scale=(n * vd) ** -0.5),
    }


def mla_forward(cfg, params, x, *, positions, theta: float, cache: Optional[dict] = None,
                cache_pos: Optional[int] = None, chunk: int = 0, return_kv: bool = False,
                train: bool = False):
    """MLA. Prefill / train: the expanded computation (``mha`` with
    ``chunk`` when ``train``, else ``ops.flash_attention``). Decode: the
    absorbed form, attending directly over the compressed (c_kv, k_rope)
    cache of lora + rope_dim values a token; the new entry is written at the
    clamped slot in place (as ``attn_forward``'s decode), and the returned
    cache is the same dict."""
    B, S, _ = x.shape
    n = cfg.num_heads
    nope, rope_d, vd, lora = (
        cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank,
    )

    q = _split_heads(mm(x, params["wq"]), n, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    sin, cos = rope_angles(positions, rope_d, theta)
    q_rope = apply_rope(q_rope, sin, cos)

    dkv = mm(x, params["w_dkv"])
    c_kv = rmsnorm(dkv[..., :lora], params["kv_norm"])
    k_rope = apply_rope(dkv[..., None, lora:], sin, cos)[:, :, 0]  # (B, S, rope)

    scale = (nope + rope_d) ** -0.5

    if cache is None:
        # expanded path: k_rope is one head, broadcast over the n heads
        k_nope = _split_heads(mm(c_kv, params["w_uk"]), n, nope)
        v = _split_heads(mm(c_kv, params["w_uv"]), n, vd)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, n, rope_d)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        if train:
            o = mha(qfull, k, v, q_positions=positions, k_positions=positions, causal=True,
                    chunk=chunk)
        else:
            o = ops.flash_attention(qfull, k, v, causal=True, q_offset=0)
        y = mm(o.reshape(B, S, n * vd), params["wo"])
        if return_kv:
            return y, {"c_kv": c_kv, "k_rope": k_rope}
        return y, None

    # absorbed decode: the write lands where the reference's
    # dynamic_update_slice clamps it; the keys at or before cache_pos attend
    at = max(0, min(cache_pos, cache["c_kv"].shape[1] - S))
    write_seq(cache["c_kv"], at, c_kv.to(cache["c_kv"].dtype))
    write_seq(cache["k_rope"], at, k_rope.to(cache["k_rope"].dtype))
    w_uk = params["w_uk"].reshape(lora, n, nope)
    # absorb W_uk into the query: q_lat (B, S, n, lora), joined to q_rope,
    # both fp32 (a few hundred KB; the cache is read where it lies)
    q_lat = torch.einsum("bqnd,lnd->bqnl", q_nope.to(torch.float32), w_uk.to(torch.float32))
    q_abs = torch.cat([q_lat, q_rope.to(torch.float32)], dim=-1)
    ctx_lat = ops.latent_decode(q_abs, cache["c_kv"], cache["k_rope"], scale=scale,
                                q_offset=cache_pos)
    w_uv = params["w_uv"].reshape(lora, n, vd)
    ctx = torch.einsum("bqnl,lnv->bqnv", ctx_lat, w_uv.to(torch.float32))
    y = mm(ctx.reshape(B, S, n * vd).to(x.dtype), params["wo"])
    return y, cache


def init_mla_cache(cfg, batch: int, seq: int, dtype, device=None, lead: tuple = ()):
    """The compressed cache: one zeroed ``lead + (batch, seq, lora +
    rope_dim)`` buffer, returned as the reference's two leaves, ``c_kv``
    (its first lora columns) and ``k_rope`` (the rest), views of it. The
    latent decode kernel reads a key's row of both where it lies. ``lead``
    stacks the repeats of a scanned unit in the same buffer."""
    lora = cfg.kv_lora_rank
    buf = torch.zeros(tuple(lead) + (batch, seq, lora + cfg.qk_rope_dim), dtype=dtype,
                      device=device)
    return {"c_kv": buf[..., :lora], "k_rope": buf[..., lora:]}
