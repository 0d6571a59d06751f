"""The port's two-tier mean on ``torch.distributed`` against the JAX
package's ``shard_map`` schedule: the reference on 8 virtual devices (as
``tests/test_hierarchy.py`` runs it, in a subprocess) and the port on 8
gloo ranks of a (2, 2, 2) ("pod", "data", "model") mesh, on the same numpy
draw; the one-rank fallback; ``make_host_mesh``'s device rule."""
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.sharding.hierarchy import edge_only_mean, hier_grad_mean

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import compat_mesh
from repro.sharding.hierarchy import edge_only_mean, hier_grad_mean

x = dict(np.load(sys.argv[1]))
mesh = compat_mesh((2, 2, 2), ("pod", "data", "model"))
with mesh:
    tree = {k: jnp.asarray(v) for k, v in x.items()}
    hier = hier_grad_mean(tree, mesh)
    edge = edge_only_mean(tree, mesh)
np.savez(sys.argv[2], **{"hier_" + k: np.asarray(v) for k, v in hier.items()},
         **{"edge_" + k: np.asarray(v) for k, v in edge.items()})
"""

PORT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.hierarchy import edge_only_mean, hier_grad_mean

rank, world, store, inp, out = int(sys.argv[1]), 8, sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
mesh = make_host_mesh(2, 2, pod=2, device="cpu")
pod, data, _ = mesh.get_coordinate()
group = pod * 2 + data  # the batch splits over ("pod", "data"), pod major
x = dict(np.load(inp))
tree = {k: torch.from_numpy(v[2 * group: 2 * group + 2]) for k, v in x.items()}
hier = hier_grad_mean(tree, mesh)
edge = edge_only_mean(tree, mesh)
res = {"hier_" + k: v.numpy() for k, v in hier.items()}
res.update({"edge_" + k: v.full_tensor().numpy() for k, v in edge.items()})
res["shape"] = np.asarray(tuple(mesh.shape))
np.savez(out, **res)
dist.destroy_process_group()
"""


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def test_eight_gloo_ranks_match_the_references_eight_devices(tmp_path):
    rng = np.random.default_rng(0)
    x = {"w": rng.normal(0, 1, (8, 5)).astype(np.float32),
         "b": rng.normal(0, 1, (8,)).astype(np.float32),
         "m": rng.normal(0, 1, (8, 3, 4)).astype(np.float32)}
    inp = tmp_path / "x.npz"
    np.savez(inp, **x)
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(inp), str(tmp_path / "ref.npz")],
                           env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks = [subprocess.Popen([sys.executable, "-c", PORT, str(r), str(tmp_path / "store"),
                               str(inp), str(tmp_path / f"rank{r}.npz")],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(8)]
    logs = [p.communicate(timeout=240)[0] for p in [ref, *ranks]]
    assert all(p.returncode == 0 for p in [ref, *ranks]), "\n".join(logs)
    want = dict(np.load(tmp_path / "ref.npz"))
    for r in range(8):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert tuple(got.pop("shape")) == (2, 2, 2)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape == v.shape, (r, k)
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=f"rank {r} {k}")
    for k, v in x.items():
        np.testing.assert_allclose(want["hier_" + k], v.mean(0), rtol=0, atol=1e-6)
        # each pod's edge aggregate is the mean of its half of the batch
        np.testing.assert_allclose(want["edge_" + k][0], v[:4].mean(0), rtol=0, atol=1e-6)
        np.testing.assert_allclose(want["edge_" + k][1], v[4:].mean(0), rtol=0, atol=1e-6)


@pytest.fixture
def one_rank_group():
    """A test that starts a one-rank process group leaves none behind."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_one_rank_mesh_is_the_flat_mean_bit_for_bit(one_rank_group):
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh

    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 3, generator=g), "b": [torch.randn(4, generator=g)],
            "h": torch.randn(2, 5, dtype=torch.bfloat16, generator=g)}
    flat = {"w": tree["w"].mean(0), "b": [tree["b"][0].mean(0)], "h": tree["h"].mean(0)}

    def same(a, b):
        assert a.keys() == b.keys()
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"][0], b["b"][0])
        assert torch.equal(a["h"], b["h"]) and a["h"].dtype == torch.bfloat16

    # no mesh: the reference's fallback
    same(hier_grad_mean(tree, None), flat)
    same(edge_only_mean(tree, None), flat)
    mesh2 = make_host_mesh(device="cpu")
    same(hier_grad_mean(tree, mesh2), flat)
    same(edge_only_mean(tree, mesh2), flat)  # no pod axis: plain edge means
    mesh3 = make_host_mesh(pod=1, device="cpu")
    same(hier_grad_mean(tree, mesh3), flat)
    edge = edge_only_mean(tree, mesh3)  # one pod: a (1, ...) array of pods
    assert isinstance(edge["w"], DTensor) and edge["w"].full_tensor().shape == (1, 3)
    same({"w": edge["w"].full_tensor()[0], "b": [edge["b"][0].full_tensor()[0]],
          "h": edge["h"].full_tensor()[0]}, flat)


def test_make_host_mesh_clamps_and_keeps_the_device_rule(one_rank_group):
    from repro_torch.launch.mesh import axis_sizes, make_host_mesh

    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh()
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = make_host_mesh(4, 4, device="cpu")  # one rank: clamped to (1, 1)
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert axis_sizes(mesh) == {"data": 1, "model": 1}
    assert axis_sizes(make_host_mesh(2, 2, pod=2, device="cpu")) == {"pod": 1, "data": 1,
                                                                       "model": 1}


def test_hw_names_the_card():
    from repro_torch.launch.mesh import HW, card_memory

    assert HW["device"] == "NVIDIA H100 80GB HBM3" and HW["power_limit_w"] == 700.0
    assert HW["peak_flops_bf16"] == 989e12 and HW["hbm_bw"] == 3.35e12
    assert HW["nvlink_bw"] == 450e9
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        assert card_memory() == HW["hbm_bytes"]
    json.dumps(HW)
