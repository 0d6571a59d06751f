"""Attention: GQA (full / sliding-window / causal) with a KV cache.

Counterpart of the GQA part of ``repro.models.attention``; MLA and cross
attention wait (ROADMAP A4).

Conventions
-----------
* q/k/v layout: (batch, seq, heads, head_dim).
* KV caches: dict(k=(B, S, K, H), v=(B, S, K, H)).
* ``attn_forward`` computes attention with ``ops.flash_attention``: the
  hand-written kernel on the card, its plain version
  (``kernels.ref.flash_attention_ref``) on the CPU. The reference's jnp
  ``mha`` has no counterpart here; the tests hold ``ops.flash_attention``
  to it directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, mm, rmsnorm, rope_angles


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
    return x.reshape(x.shape[:-1] + (n, hd))


def attn_forward(cfg, params, x, *, positions, theta: float, window: int = 0,
                 cache: Optional[dict] = None, cache_pos: Optional[int] = None,
                 kv_mult: int = 1, return_kv: bool = False):
    """Self-attention forward.

    Modes:
      * train/prefill: cache is None; full-sequence causal attention.
        return_kv=True additionally returns the (k, v) to seed a cache.
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
    cache["k"][:, at:at + S] = k.to(cache["k"].dtype)
    cache["v"][:, at:at + S] = v.to(cache["v"].dtype)
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
