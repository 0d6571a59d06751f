"""Meshes: the production meshes as descriptions, and a real
``torch.distributed`` mesh over the ranks this process group has.

Counterpart of ``repro.launch.mesh``. The reference builds every mesh with
``jax.make_mesh`` over devices that exist, or that ``XLA_FLAGS`` fakes
(512 host devices for its dry run). One process of the port cannot hold
256 ranks, so the production meshes are ``MeshSpec``s, axis names and
sizes and no device, as the reference's own tests stub them
(``tests/test_substrates.py``). ``make_host_mesh`` gives a
``DeviceMesh`` over the ranks of the process group, starting a one-rank
group itself when none is up. ``make_fake_mesh`` gives a ``DeviceMesh``
of a ``MeshSpec``'s shape over a fake process group (torch's ``"fake"``
backend: every rank but this one imagined, no collective run, no device
touched), on which
``launch.dryrun`` traces a step laid out as the production mesh lays it
out. The spec rules (``repro_torch.sharding``) read every kind through
``axis_sizes``.

``HW`` holds the constants of the card the port runs on, where the
reference's hold the TPU v5e's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device

# The card: NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit. Peak
# rates from NVIDIA's H100 SXM5 datasheet (dense bf16 989 TFLOP/s, HBM3
# 3.35 TB/s, NVLink 900 GB/s both directions together, 450 GB/s each way);
# memory as ``torch.cuda.get_device_properties(0).total_memory`` reports it
# on that card (85.02 GB, ``PERF.md`` §4).
HW = {
    "device": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,  # per card, dense
    "hbm_bw": 3.35e12,  # bytes/s per card
    "nvlink_bw": 450e9,  # bytes/s per card and direction
    "hbm_bytes": 85_017_493_504,  # total_memory; read from the card when one is up
}


def card_memory() -> int:
    """The card's memory in bytes: ``total_memory`` of card 0 when one is
    up, else ``HW["hbm_bytes"]``."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return int(HW["hbm_bytes"])


@dataclass(frozen=True)
class MeshSpec:
    """A mesh with no devices: its axis names in order and their sizes."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``MeshSpec``, a ``DeviceMesh``, or any object
    with ``axis_names`` and a ``shape`` mapping (the reference's stubs)."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh: its shape is a tuple
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16 x 16 = 256 cards a pod over ("data", "model"); two pods, 512
    cards, over ("pod", "data", "model")."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def _ensure_group(dev: torch.device) -> None:
    """Start a one-rank process group on an in-process store (no network)
    if none is up: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int | None = None,
                   device="cuda"):
    """A ``DeviceMesh`` over the process group's ranks: (data, model) over
    ("data", "model"), or with ``pod`` (pod, data, model) over ("pod",
    "data", "model"). Sizes are clamped to the ranks there are, as the
    reference's: data to the world size, model to what data leaves (and pod
    first, when given). Rank r sits at the row-major position r. Without a
    process group it starts a one-rank one (``_ensure_group``). Raises
    without a card unless ``device="cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    _ensure_group(dev)
    n = dist.get_world_size()
    if pod is None:
        data = min(data, n)
        model = max(1, min(model, n // max(data, 1)))
        shape, names = (data, model), ("data", "model")
    else:
        pod = max(1, min(pod, n))
        data = max(1, min(data, n // pod))
        model = max(1, min(model, n // (pod * data)))
        shape, names = (pod, data, model), ("pod", "data", "model")
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=names)


def fake_group_size() -> int | None:
    """The world size of this process's fake process group, or None when
    no group is up or the group is a real one."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_backend() != "fake":
        return None
    return dist.get_world_size()


def make_fake_mesh(spec: MeshSpec):
    """A ``DeviceMesh`` with ``spec``'s axis names and sizes over a fake
    process group of ``spec.size`` ranks, this process rank 0, started here
    if none is up. Raises if this process holds a real group, or a fake
    one of another size: a fake group never shares a process with a real
    one (``launch.dryrun`` traces in a child process)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    size = fake_group_size()
    if size is None:
        if dist.is_initialized():
            raise RuntimeError("a real process group is up: a fake mesh needs a process of "
                               "its own")
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=spec.size)
    elif size != spec.size:
        raise RuntimeError(f"the fake group has {size} ranks, the mesh {spec.size}")
    ranks = torch.arange(spec.size).reshape(spec.sizes)
    # a "cuda" mesh where torch is built for CUDA (no card need be visible:
    # the fake group touches none), so that DTensor runs the card's
    # collectives; a CPU-only build's DTensor cannot propagate some backward
    # ops on a "cuda" mesh, and on its "cpu" mesh runs a shard-to-shard
    # redistribution as an all-gather and a slice (gloo has no all-to-all)
    device = "cuda" if torch.backends.cuda.is_built() else "cpu"
    return DeviceMesh(device, ranks, mesh_dim_names=spec.axis_names)
