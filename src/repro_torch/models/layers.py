"""Shared low-level LM layers: initializers, norms, RoPE, MLP variants, vocab
padding.

Counterpart of ``repro.models.layers``. Plain functions over parameter
trees of tensors. Weights keep the reference's ``(in, out)`` layout and
are applied as ``x @ w``. Where the reference mixes dtypes in a product
(an fp32 activation against a bf16 weight), ``mm`` promotes both operands
as jnp does, since ``torch.matmul`` refuses mixed dtypes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _trunc_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], fp32, drawn from ``gen`` on
    ``device`` (the generator's own device)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init, ``(in_dim, out_dim)``, on the
    generator's device."""
    if scale is None:
        scale = in_dim**-0.5
    return (_trunc_normal(gen, (in_dim, out_dim), gen.device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    return (_trunc_normal(gen, (vocab, dim), gen.device) * 0.02).to(dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jnp's dtype promotion (fp32 @ bf16 computes in fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def init_norm(cfg, d: int, device=None):
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def apply_norm(cfg, params, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions, dim: int, theta: float):
    """positions: (...,) int -> sin/cos of shape (..., dim/2), fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., S, n, dim); sin/cos: (..., S, dim/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg, d: int, ff: int, dtype):
    if cfg.mlp_act.endswith("_glu"):
        return {
            "gate": dense_init(gen, d, ff, dtype),
            "up": dense_init(gen, d, ff, dtype),
            "down": dense_init(gen, ff, d, dtype),
        }
    return {"up": dense_init(gen, d, ff, dtype), "down": dense_init(gen, ff, d, dtype)}


def apply_mlp(cfg, params, x):
    act = cfg.mlp_act
    if act == "silu_glu":
        h = F.silu(mm(x, params["gate"])) * mm(x, params["up"])
    elif act == "gelu_glu":
        h = F.gelu(mm(x, params["gate"]), approximate="tanh") * mm(x, params["up"])
    elif act == "sq_relu":
        h = torch.square(F.relu(mm(x, params["up"])))
    elif act == "gelu":
        h = F.gelu(mm(x, params["up"]), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_act {act}")
    return mm(h, params["down"])


# ---------------------------------------------------------------------------
# vocab padding
# ---------------------------------------------------------------------------


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    """Pad the vocab to a multiple of 128 (the reference's layout; the port
    keeps it so parameter trees convert one to one)."""
    return ((vocab + multiple - 1) // multiple) * multiple


def mask_padded_logits(logits, vocab: int):
    """Set logits of padded vocab slots to a large negative value."""
    v_pad = logits.shape[-1]
    if v_pad == vocab:
        return logits
    ids = torch.arange(v_pad, device=logits.device)
    return torch.where(ids < vocab, logits, torch.finfo(torch.float32).min / 2)
