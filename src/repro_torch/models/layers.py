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
    """``a @ b`` with jnp's dtype promotion (fp32 @ bf16 computes in fp32).
    A DTensor ``a`` is first made whole on its inner dimensions
    (``whole_inner``), and a partial sum summed: ``@`` folds the inner
    dimensions into the rows, and DTensor would scatter a partial sum over
    one of them; the gradients of ``a`` and of the product keep their
    forward layouts (``pin_grad``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return matmul(a.to(dt), b.to(dt))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; a DTensor ``a`` of more than two dimensions as ``mm``
    takes it."""
    if a.dim() > 2 and hasattr(a, "placements"):
        # both gradients laid out as the forward's: a's reaches the fold
        # that made a (the heads merged back, an unflattened stream)
        return pin_grad(pin_grad(whole_inner(a, summed=True)) @ b)
    return a @ b


# ---------------------------------------------------------------------------
# DTensor layouts (a step laid out over a mesh); each returns a plain tensor
# as it is
# ---------------------------------------------------------------------------


def pin_grad(x):
    """A DTensor ``x`` as it is, its gradient redistributed to ``x``'s
    layout before it flows back: a gradient that reaches a fold (the rows of
    ``@``, ``flatten_rows``) with another layout (an inner dimension
    sharded, rows over more axes than the batch divides) cannot be viewed
    back. Any other tensor as it is."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    # the gradient of a partial sum is whole on every device
    grad = [Replicate() if p.is_partial() else p for p in x.placements]
    return DTensor.from_local(x.to_local(grad_placements=grad), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape, stride=x.stride())


def whole_inner(x: torch.Tensor, *, summed: bool = False) -> torch.Tensor:
    """A DTensor ``x`` (lead, ..., d) with every dimension between the
    first and the last replicated (the sequence of the sequence-parallel
    stream gathered, as before a column-parallel product), and with
    ``summed`` a partial sum summed too: a fold of the leading dimensions
    into rows may keep only the first of them sharded (DTensor refuses, or
    from torch 2.13 strides, any other). Any other tensor as it is."""
    if not hasattr(x, "placements") or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard

    x = normalized(x)
    out = [Replicate() if (isinstance(p, Shard) and 0 < p.dim < x.dim() - 1)
           or (summed and _summed_partial(p)) else p for p in x.placements]
    return x if out == list(x.placements) else x.redistribute(x.device_mesh, out)


def one_axis(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` with each dimension sharded over one mesh axis at
    most: of the axes that split one dimension (the batch over "pod" and
    "data"), the last keeps it split and the others replicate it (torch
    2.11's DTensor has no indexing rule for a dimension split over several
    axes). Any other tensor as it is."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import Replicate, Shard

    x = normalized(x)
    last = {p.dim: i for i, p in enumerate(x.placements) if isinstance(p, Shard)}
    out = [Replicate() if isinstance(p, Shard) and last[p.dim] != i else p
           for i, p in enumerate(x.placements)]
    return x if out == list(x.placements) else x.redistribute(x.device_mesh, out)


def _summed_partial(p) -> bool:
    """A partial sum (DTensor's other partials, an average or a max of
    equal values on each device, are left to it: its backward cannot turn
    a summed gradient into an averaged one)."""
    return p.is_partial() and getattr(p, "reduce_op", "sum") == "sum"


def normalized(x):
    """A DTensor ``x`` whose placements name a dimension from the end
    (``Shard(-1)``, which some of DTensor's own rules make and its view
    rules then refuse) relabelled from the front: the same shards, no data
    moved, the gradient relabelled back the same way."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    out = [Shard(p.dim % x.dim()) if isinstance(p, Shard) and p.dim < 0 else p
           for p in x.placements]
    if out == list(x.placements):
        return x
    grad = [Replicate() if p.is_partial() else p for p in out]
    return DTensor.from_local(x.to_local(grad_placements=grad), x.device_mesh, out,
                              run_check=False, shape=x.shape, stride=x.stride())


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. A DTensor table whose rows (the vocabulary) are
    sharded looks up on each device the ids its shard holds, zeros
    elsewhere, a partial sum over the vocabulary's axes (a vocab-parallel
    embedding: DTensor has no rule for indexing a sharded table by ids
    sharded over several axes); ``kernels.ops.on_shards`` gives the table
    its partial gradient over the ids' batch axes."""
    if not hasattr(table, "placements"):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    # the mesh axes that split the vocabulary (an axis of one splits nothing)
    rows = [i for i, p in enumerate(table.placements) if isinstance(p, Shard)
            and mesh.shape[i] > 1]
    if any(table.placements[i] != Shard(0) for i in rows) or len(rows) > 1:
        raise NotImplementedError(f"an embedding table laid out as {table.placements}")
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ids = normalized(ids)
    ip = [Replicate() if i in rows else p for i, p in enumerate(ids.placements)]
    out = [Partial() if i in rows else p for i, p in enumerate(ip)]
    width = -(-table.shape[0] // mesh.shape[rows[0]]) if rows else table.shape[0]
    first = mesh.get_local_rank(rows[0]) * width if rows else 0

    def look_up(t, i):
        if not rows:
            return t[i]
        i = i.long() - first
        held = (i >= 0) & (i < t.shape[0])
        got = t[i.clamp(0, t.shape[0] - 1)]
        return torch.where(held[..., None], got, torch.zeros((), dtype=got.dtype,
                                                               device=got.device))

    from repro_torch.kernels.ops import on_shards

    return on_shards(look_up, mesh, [(table, tuple(table.placements)), (ids, tuple(ip))],
                     tuple(out))


def unflatten_rows(y: torch.Tensor, rows: torch.Tensor, shape) -> torch.Tensor:
    """(rows, d) ``y`` computed from ``flatten_rows``' ``rows`` as ``shape``.
    A DTensor ``y`` is first laid out as ``rows`` are, so that the view is
    the inverse of the fold (rows sharded over more mesh axes than the
    leading dimension divides cannot be viewed back), and its gradient is
    laid out as the result is (``pin_grad``)."""
    if hasattr(y, "placements") and hasattr(rows, "placements"):
        from torch.distributed.tensor import Replicate

        y = y.redistribute(rows.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in rows.placements])
    return pin_grad(y.reshape(shape))


def write_seq(dst: torch.Tensor, at: int, new: torch.Tensor) -> None:
    """``dst[:, at:at + S] = new`` in place (S = ``new.shape[1]``): a decode
    step's cache write. For a DTensor ``dst`` each device writes the part of
    the slots that its shard holds (a cache sharded on the sequence holds
    slot ``at`` on one device only): DTensor's own slice assignment would
    gather such a cache and write into the gathered copy."""
    if not hasattr(dst, "placements"):
        dst[:, at:at + new.shape[1]] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = dst.device_mesh
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in dst.placements]
    new = new.redistribute(mesh, whole).to_local()
    shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
    lo, hi = max(at, offset[1]), min(at + new.shape[1], offset[1] + shape[1])
    if lo < hi:
        dst.to_local()[:, lo - offset[1]:hi - offset[1]] = new[:, lo - at:hi - at]


def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """``x`` (..., n * hd) as (..., n, hd). A DTensor whose last dimension
    is sharded over a mesh axis that does not divide ``n`` (whisper-small's
    12 heads, 768 wide, on a 16-way "model" axis) is first gathered on that
    axis: DTensor does not unflatten an uneven shard, where the reference's
    compiler reshards it."""
    if hasattr(x, "placements"):
        x = whole_on(x, x.dim() - 1, lambda size: n % size != 0)
    return x.reshape(x.shape[:-1] + (n, hd))


def whole_on(x, dim: int, where=lambda size: True):
    """A DTensor ``x`` with its dimension ``dim`` replicated on each mesh
    axis that shards it and whose size passes ``where``; any other tensor
    as it is."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.dim()
    x = normalized(x)
    out = [Replicate() if isinstance(p, Shard) and p.dim == dim and where(size) else p
           for p, size in zip(x.placements, x.device_mesh.shape)]
    return x if out == list(x.placements) else x.redistribute(x.device_mesh, out)


def flatten_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., d) as (rows, d). A DTensor is made ``whole_inner`` and
    summed first, and its rows' gradient laid out as the rows are
    (``pin_grad``)."""
    return pin_grad(whole_inner(x, summed=True).reshape(-1, x.shape[-1]))


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
    """The config's norm of ``x``; a DTensor's partial sums (the residual
    stream after a row-parallel product or the vocab-parallel embedding)
    are summed first, once, so that the products that read the norm's
    output take whole values."""
    if hasattr(x, "placements") and any(_summed_partial(p) for p in x.placements):
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh, [Replicate() if _summed_partial(p) else p
                                           for p in x.placements])
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
