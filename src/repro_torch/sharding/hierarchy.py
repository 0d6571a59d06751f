"""Hierarchical aggregation as an explicit two-stage collective schedule on
``torch.distributed``.

Counterpart of ``repro.sharding.hierarchy``. The EEC-NET tree maps onto
the mesh: the "data" axis plays the edge tier (each edge server aggregates
its clients' updates) and the "pod" axis the cloud tier (the cloud
aggregates edge aggregates). The reference writes the schedule with
``shard_map`` and ``lax.psum``; here each rank runs it on its own rows with
``all_reduce`` over the mesh dimension's process group, so per-tier
traffic is one collective each, and tier-local rounds (kappa2 > 1: edge-only
syncs between cloud aggregations) are expressible.

A tree's leaves are batch-leading, (B_local, ...): a rank's own rows of a
batch split over ("pod", "data") (a DTensor's local shard, or a plain
tensor holding them). Ranks that differ only along "model" hold the same
rows.

Semantics (tested against the flat global mean and the reference's
8-device run):
  hier_grad_mean: per-group mean, then a sum over "data" (edge tier), then
  over "pod" (cloud tier), divided by the number of groups; every rank
  ends with the global mean.
  edge_only_mean: per-group mean, then the mean over "data" only; each pod
  keeps its own edge aggregate, returned as a DTensor sharded over "pod"
  whose ``full_tensor()`` is the reference's (n_pod, ...) array.

Without a mesh, or on a mesh without those axes, both are ``mean(0)``. On
a one-rank mesh every ``all_reduce`` is an identity, so both are
``mean(0)`` bit for bit.
"""
from __future__ import annotations

from repro_torch.tree import tree_map


def _data_axes(mesh, edge_axis, cloud_axis) -> tuple:
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    return tuple(a for a in (cloud_axis, edge_axis) if a in names)


def _local(x):
    """A rank's rows: a DTensor's local shard, or the tensor itself."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _sum_over(x, mesh, axis):
    import torch.distributed as dist

    dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def hier_grad_mean(tree, mesh, *, edge_axis: str = "data", cloud_axis: str = "pod"):
    """Global mean of batch-leading leaves by the two-stage schedule.

    Stage 1: each rank's mean over its rows (a client group's aggregate);
    stage 2: ``all_reduce`` over ``edge_axis`` (edge aggregation); stage 3:
    ``all_reduce`` over ``cloud_axis`` (cloud aggregation); then divide by
    the number of groups. Returns plain tensors of shape (...), equal on
    every rank: the global mean."""
    axes = _data_axes(mesh, edge_axis, cloud_axis)
    if not axes:
        return tree_map(lambda x: _local(x).mean(0), tree)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_groups = 1
    for a in axes:
        n_groups *= sizes[a]

    def staged(x):
        local = _local(x).mean(0)  # client-group mean
        if edge_axis in sizes:  # edge tier
            local = _sum_over(local, mesh, edge_axis)
        if cloud_axis in sizes:  # cloud tier
            local = _sum_over(local, mesh, cloud_axis)
        return local / n_groups

    return tree_map(staged, tree)


def edge_only_mean(tree, mesh, *, edge_axis: str = "data", cloud_axis: str = "pod"):
    """kappa2 > 1 rounds: aggregate within the edge tier only; each pod
    keeps its own edge-tier aggregate (the cloud sees it at the next cloud
    round). With a ``cloud_axis`` on the mesh each leaf is a DTensor of
    local shape (1, ...) sharded over it (replicated over the other axes),
    whose ``full_tensor()`` is the (n_pod, ...) array of the pods' means;
    without one, the plain (...) edge mean."""
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    if edge_axis not in names:
        return tree_map(lambda x: _local(x).mean(0), tree)
    sizes = dict(zip(names, mesh.shape))
    n_edge = sizes[edge_axis]

    def staged(x):
        local = _sum_over(_local(x).mean(0), mesh, edge_axis) / n_edge
        if cloud_axis not in names:
            return local
        from torch.distributed.tensor import DTensor, Replicate, Shard

        placements = [Shard(0) if a == cloud_axis else Replicate() for a in names]
        return DTensor.from_local(local[None], mesh, placements, run_check=False)

    return tree_map(staged, tree)
