"""Partition-spec rule engine for every architecture family.

Counterpart of ``repro.sharding.specs``, with the reference's rules over
the port's trees (nested dicts and lists, ``repro_torch.tree``; their leaf
paths are the reference's). A spec is a plain tuple with one entry per
leading dimension it names: an axis name, a tuple of axis names (the
dimension split over each in turn, major first), or ``None`` for a
replicated dimension; ``()`` replicates the whole leaf. ``tuple(P(...))``
of the reference's ``PartitionSpec`` is the same tuple.

The mesh is (data, model) single-pod or (pod, data, model) multi-pod; the
"pod" and "data" axes mirror the paper's cloud and edge aggregation tiers
(``sharding.hierarchy``), "model" is tensor / expert parallelism inside one
logical compute node. The rules read a mesh through
``launch.mesh.axis_sizes``, so a ``MeshSpec``, a ``DeviceMesh`` or the
reference's duck-typed stubs all work.

Rules are name-based with divisibility fallbacks: an axis is sharded over
"model" only when its size divides the model-axis size; otherwise the rule
degrades to replication for that axis (whisper-small's 12 heads on a
16-way model axis replicate its attention weights; its MLP and vocabulary
still shard). ZeRO-1: optimizer moments take the param spec with the
largest replicated axis additionally sharded over "data" when divisible
(``zero1_specs``).

``to_placements`` turns a spec into DTensor placements on a
``DeviceMesh`` (the reference's ``to_named``), ``distribute_tree`` lays a
tree out as DTensors by a spec tree (the reference's ``in_shardings``),
``gather_tree`` is its inverse, and ``constrain`` lays a DTensor out by a
spec and returns a plain tensor as it is (the reference's
``with_sharding_constraint``, which is a no-op without a mesh).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.launch.mesh import axis_sizes

Spec = tuple


def data_axes(mesh) -> tuple:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axes_entry(axes: tuple):
    """A spec entry for a tuple of axes as ``PartitionSpec`` keeps it: no
    axis is ``None``, one axis its name, more the tuple."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return axis_sizes(mesh).get(name, 1)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists, the path a tuple
    of string keys (a list index as its decimal string, as the reference's
    ``SequenceKey``); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


# Column-parallel outputs (shard LAST axis over 'model'):
_COL = {
    "wq", "wk", "wv", "gate", "up", "w_uk", "w_uv",
    "wr", "wg", "cm_wk", "cm_wr", "wz", "wx", "wdt",
}
# Row-parallel inputs (shard FIRST axis over 'model'):
_ROW = {"wo", "down", "cm_wv", "out_proj"}
# Vocab-sharded embeddings (shard FIRST axis over 'model'):
_VOCAB = {"embed", "out"}
# Expert stacks (E, din, dout): shard EXPERT axis over 'model':
_EXPERT3D = {"gate", "up", "down"}
# Always replicated:
_REPL = {
    "router", "w_dkv", "lora_A", "lora_B", "decay_A", "decay_B",
    "wB", "wC", "pos_embed", "enc_pos",
}


def _spec_for(path_keys: tuple[str, ...], shape: tuple[int, ...], tp: int) -> Spec:
    name = path_keys[-1]
    in_moe = "moe" in path_keys
    if name in _REPL and not (in_moe and name in _EXPERT3D and len(shape) == 3):
        return ()
    if len(shape) == 3 and name in _EXPERT3D:  # (E, din, dout) expert stack
        return ("model", None, None) if shape[0] % tp == 0 else ()
    if name in _VOCAB and len(shape) == 2:
        return ("model", None) if shape[0] % tp == 0 else ()
    if name in _COL and len(shape) == 2:
        return (None, "model") if shape[1] % tp == 0 else ()
    if name in _ROW and len(shape) == 2:
        return ("model", None) if shape[0] % tp == 0 else ()
    if name == "conv_x" and len(shape) == 2:
        return (None, "model") if shape[1] % tp == 0 else ()
    return ()  # norms, biases, scalars, small tensors


def param_specs(cfg, opts, params_shapes, mesh) -> Any:
    """A spec per leaf of ``params_shapes`` (``launch.steps.param_shapes``,
    or real params), in a tree of the same structure.

    Stacked repeats ("unit" leaves, "encoder" layers) carry a leading
    repeat axis: the rules apply to the per-layer shape and the leading
    axis stays unsharded. Attention heads that do not tile the model axis
    after KV replication have already fallen back to replication by the
    divisibility checks."""
    tp = _axis_size(mesh, "model")

    def visit(keys, leaf):
        shape = tuple(leaf.shape)
        if ("unit" in keys or "encoder" in keys) and len(shape) >= 2:
            return (None, *_spec_for(keys, shape[1:], tp))
        return _spec_for(keys, shape, tp)

    return _map_with_path(visit, params_shapes)


def zero1_specs(param_spec_tree, params_shapes, mesh) -> Any:
    """Optimizer-moment specs: each param spec with its largest replicated
    axis (of at least the data-axis size, divisible by it) sharded over
    "data"; a leaf of fewer than two dimensions keeps its spec."""
    nd = _axis_size(mesh, "data")

    def visit(spec, leaf):
        dims = list(spec) + [None] * (leaf.dim() - len(spec))
        best, best_size = -1, 0
        for i, (d, s) in enumerate(zip(dims, leaf.shape)):
            if d is None and s % nd == 0 and s > best_size and s >= nd:
                best, best_size = i, s
        if best >= 0 and leaf.dim() >= 2:
            dims[best] = "data"
            return tuple(dims)
        return spec

    return _zip_specs(visit, param_spec_tree, params_shapes)


def _zip_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and a tensor tree of one
    structure (a spec tuple is a leaf)."""
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, specs[k], tree[k]) for k in specs}
    if isinstance(specs, list):
        return [_zip_specs(fn, s, t) for s, t in zip(specs, tree)]
    if specs is None:
        return None
    return fn(specs, tree)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------


def batch_specs(cfg, mode: str, global_batch: int, mesh) -> dict:
    """Specs of the input batch's entries (``launch.steps.input_specs``)."""
    dp = data_axes(mesh)
    ndp = _axis_size(mesh, dp)
    ok = global_batch % max(ndp, 1) == 0 and global_batch >= ndp
    bspec = axes_entry(dp) if ok else None
    specs: dict[str, Spec] = {}
    if mode in ("train", "prefill"):
        specs["tokens"] = (bspec, None)
        if mode == "train":
            specs["labels"] = (bspec, None)
        if cfg.frontend == "vision_stub":
            specs["media"] = (bspec, None, None)
        if cfg.enc_dec:
            specs["frames"] = (bspec, None, None)
    else:  # decode
        specs["token"] = (bspec, None)
        specs["pos"] = ()
    return specs


def cache_specs(cfg, opts, cache_shapes, mesh, *, batch: int, seq: int) -> Any:
    """Decode-state specs. Batch over the data axes when divisible; KV and
    SSM heads over "model"; for batch = 1 long context, the sequence axis
    over the data axes instead (flash-decoding style). ``seq`` is the
    reference's argument, which its rules do not read either."""
    ndp = _axis_size(mesh, data_axes(mesh))
    dp = axes_entry(data_axes(mesh))
    tp = _axis_size(mesh, "model")
    batch_ok = batch % max(ndp, 1) == 0 and batch >= ndp
    bdim = dp if batch_ok else None

    def visit(keys, leaf):
        name = keys[-1]
        shp = tuple(leaf.shape)
        # unit states have shape (n_repeats, B, ...): the rules read the rest
        stacked = "unit" in keys
        core = shp[1:] if stacked else shp

        def wrap(*spec):
            return ((None,) if stacked else ()) + spec

        if name in ("k", "v") and len(core) == 4:
            _, S, K, _ = core
            kv_ok = K % tp == 0
            # kv heads that cannot tile the model axis (llama3.2's 8 on tp
            # 16 with 24 q heads) shard the SEQUENCE over 'model' instead
            seq_model = (not kv_ok) and S % tp == 0
            heads = "model" if kv_ok else None
            if batch_ok:
                return wrap(dp, "model" if seq_model else None, heads, None)
            if S % max(ndp, 1) == 0:
                return wrap(None, dp, heads, None)
            return wrap(None, None, heads, None)
        if name in ("c_kv", "k_rope") and len(core) == 3:
            S = core[1]
            if batch_ok:
                return wrap(dp, None, None)
            if S % max(ndp, 1) == 0:
                return wrap(None, dp, None)
            return wrap(None, None, None)
        if name == "s" and len(core) == 4:  # ssm state (B, H, p, n)
            return wrap(bdim, "model" if core[1] % tp == 0 else None, None, None)
        if name in ("tm_x", "cm_x") and len(core) == 2:
            return wrap(bdim, "model" if core[1] % tp == 0 else None)
        if name in ("conv_x", "conv_BC") and len(core) == 3:
            return wrap(bdim, None, "model" if core[2] % tp == 0 else None)
        if name == "enc_out":
            return (bdim, None, None)
        return (None,) * len(shp)

    return _map_with_path(visit, cache_shapes)


# ---------------------------------------------------------------------------
# per-device bytes, DTensor placements
# ---------------------------------------------------------------------------


def shard_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """One device's shard of a ``shape`` laid out by ``spec``: each named
    dimension divided by its axes' sizes (rounded up, as XLA pads an
    uneven split)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(-(-s // (_axis_size(mesh, d) if d is not None else 1))
                 for s, d in zip(shape, dims))


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of a tensor tree laid out by a spec tree of
    the same structure (XLA's ``argument_size_in_bytes`` of such inputs)."""
    total = 0

    def add(spec, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):  # a decode position is a Python int
            total += math.prod(shard_shape(leaf.shape, spec, mesh)) * leaf.element_size()
        return spec

    _zip_specs(add, specs, tree)
    return total


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``: mesh
    dimension i is ``Shard(d)`` if tensor dimension d names its axis
    (alone or in a tuple), else ``Replicate()``. A dimension over a tuple
    of axes is split over them major first, as DTensor splits a dimension
    sharded on several mesh dimensions in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, s in enumerate(spec)
                    if s == name or (isinstance(s, tuple) and name in s)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def distribute_tree(tree, specs, mesh) -> Any:
    """``tree`` laid out as DTensors on ``mesh`` (a ``DeviceMesh``) by a
    spec tree of the same structure, each leaf by ``to_placements``: a
    tensor with values by ``distribute_tensor`` (this rank's shard of it),
    a ``meta`` tensor (a trace) as ``DTensor.from_local`` of a ``meta``
    shard of ``shard_shape``, the shard this rank holds. A leaf that is not
    a tensor (a decode position) stays as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def lay(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        placements = to_placements(spec, mesh)
        if leaf.is_meta:
            local = torch.empty(shard_shape(leaf.shape, spec, mesh), dtype=leaf.dtype,
                                device="meta")
            return DTensor.from_local(local, mesh, placements, run_check=False,
                                      shape=leaf.shape, stride=leaf.stride())
        return distribute_tensor(leaf, mesh, placements)

    return _zip_specs(lay, specs, tree)


def gather_tree(tree) -> Any:
    """The inverse of ``distribute_tree``: every DTensor leaf gathered to
    its full tensor (a collective: every rank calls it), any other leaf as
    it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def constrain(x: torch.Tensor, spec: Spec | None) -> torch.Tensor:
    """``x`` laid out by ``spec``: a DTensor is redistributed to
    ``to_placements(spec, its mesh)``; a plain tensor, or a ``None`` spec,
    returns ``x`` unchanged (one device has nothing to lay out)."""
    from torch.distributed.tensor import DTensor

    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))
