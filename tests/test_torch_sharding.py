"""The port's sharding plane against the JAX package's: for every
architecture on a 1x1, a 16x16 and a 2x16x16 mesh (duck-typed, as the
reference's own tests stub them), with sequence parallelism off and on,
``default_opts`` field for field, ``param_specs`` and ``zero1_specs`` leaf
for leaf over the ``param_shapes`` of those opts (so with ``kv_mult`` > 1
and ``expert_pad_to`` = 16 too), ``batch_specs`` for each mode,
``cache_specs`` at (128, 32768) and (1, 524288), and one device's argument
bytes of every input shape; ``constrain`` on a plain tensor and on a
one-rank gloo DTensor."""
import dataclasses
import functools
import math
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.launch.steps import cache_shapes as jax_cache_shapes
from repro.launch.steps import default_opts as jax_default_opts
from repro.launch.steps import input_specs as jax_input_specs
from repro.launch.steps import opt_shapes as jax_opt_shapes
from repro.sharding import batch_specs as jax_batch_specs
from repro.sharding import cache_specs as jax_cache_specs
from repro.sharding import param_specs as jax_param_specs
from repro.sharding import zero1_specs as jax_zero1_specs
from repro_torch.configs import INPUT_SHAPES, get_arch
from repro_torch.launch.dryrun import reckon_argument_bytes, shape_skip_reason
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.launch.steps import cache_shapes, default_opts, param_shapes
from repro_torch.sharding import batch_specs, cache_specs, param_specs, zero1_specs
from repro_torch.sharding.specs import constrain, to_placements


class M1:
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}


class M16:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class M2x16:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"1x1": M1, "16x16": M16, "2x16x16": M2x16}
ARCHS = sorted(jax_list_archs())


def _as_jax(tree):
    """The port's meta tree as the reference's ``ShapeDtypeStruct`` tree of
    the same structure. ``tests/test_torch_shapes.py`` holds the port's
    ``param_shapes`` to the reference's ``jax.eval_shape`` trees leaf for
    leaf under these opts (tp 1 and 16), so the reference's rules see the
    tree they see in its dry run, without an ``eval_shape`` of every
    expert's init here."""
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    dtype = jax.numpy.dtype(str(tree.dtype).removeprefix("torch."))
    return jax.ShapeDtypeStruct(tuple(tree.shape), dtype)


@functools.lru_cache(maxsize=None)
def _params(arch: str, tp: int):
    """(port's meta tree, the reference's ShapeDtypeStruct tree) of the
    param shapes under default opts at a model axis of ``tp`` (the shapes
    read nothing else of the mesh)."""
    cfg = get_arch(arch)
    ps = param_shapes(cfg, default_opts(cfg, M16() if tp == 16 else M1()))
    return ps, _as_jax(ps)


def _spec_layout(tree) -> dict:
    """Path -> spec of the reference's PartitionSpec tree, as tuples."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(k): tuple(s) for k, s in flat}


def _port_layout(tree, path="") -> dict:
    """The port's spec tree with the reference's path strings."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _port_layout(tree[key], f"{path}['{key}']").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _port_layout(t, f"{path}[{i}]").items()}
    if tree is None:
        return {}
    assert isinstance(tree, tuple), path
    return {path: tree}


def _jax_bytes(shapes, specs, mesh) -> int:
    """One device's bytes of the reference's ShapeDtypeStruct tree laid out
    by its PartitionSpec tree: each named dimension divided by its axes'
    sizes, rounded up."""
    flat_s = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    flat_x = jax.tree.leaves(shapes)
    assert len(flat_s) == len(flat_x)
    total = 0
    for spec, x in zip(flat_s, flat_x):
        dims = list(spec) + [None] * (len(x.shape) - len(spec))
        n = 1
        for size, d in zip(x.shape, dims):
            names = () if d is None else (d if isinstance(d, tuple) else (d,))
            n *= -(-size // math.prod(mesh.shape[a] for a in names))
        total += n * x.dtype.itemsize
    return total


@pytest.fixture
def one_rank_group():
    """A test that starts a one-rank process group leaves none behind."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _fields(opts) -> dict:
    return {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}


@pytest.mark.parametrize("arch", ARCHS)
def test_opts_and_param_specs_match_the_reference(arch):
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    for mesh_name, M in MESHES.items():
        for seq_parallel in (False, True):
            jo = jax_default_opts(jcfg, M(), seq_parallel=seq_parallel)
            opts = default_opts(cfg, M(), seq_parallel=seq_parallel)
            want = _fields(jo)
            if want["act_spec"] is not None:
                want["act_spec"] = tuple(want["act_spec"])
            got = _fields(opts)
            # unroll_scan, the reference's Python-unrolled unit, is all the
            # port has: its default_opts leaves it off everywhere
            assert set(want) - set(got) == {"unroll_scan"} and set(got) <= set(want)
            assert want.pop("unroll_scan") is False
            assert got == want, (mesh_name, seq_parallel)
        ps, jps = _params(arch, M.shape["model"])
        jspec = jax_param_specs(jcfg, jo, jps, M())
        spec = param_specs(cfg, opts, ps, M())
        assert _port_layout(spec) == _spec_layout(jspec), mesh_name
        assert _port_layout(zero1_specs(spec, ps, M())) == _spec_layout(
            jax_zero1_specs(jspec, jps, M())), mesh_name
        # a MeshSpec reads as the duck-typed stub does
        if mesh_name != "1x1":
            prod = make_production_mesh(multi_pod=mesh_name == "2x16x16")
            assert param_specs(cfg, opts, ps, prod) == spec


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch):
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    for mesh_name, M in MESHES.items():
        for mode in ("train", "prefill", "decode"):
            for gb in (1, 32, 128, 256):
                want = {k: tuple(v) for k, v in jax_batch_specs(jcfg, mode, gb, M()).items()}
                assert batch_specs(cfg, mode, gb, M()) == want, (mesh_name, mode, gb)
        jo, opts = jax_default_opts(jcfg, M()), default_opts(cfg, M())
        for batch, seq in ((128, 32768), (1, 524288)):
            jcsh = jax_cache_shapes(jcfg, jo, SimpleNamespace(global_batch=batch, seq_len=seq))
            csh = cache_shapes(cfg, opts, batch, seq)
            want = _spec_layout(jax_cache_specs(jcfg, jo, jcsh, M(), batch=batch, seq=seq))
            got = _port_layout(cache_specs(cfg, opts, csh, M(), batch=batch, seq=seq))
            assert got == want, (mesh_name, batch, seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_argument_bytes_match_the_reference(arch):
    """``dryrun.reckon_argument_bytes`` (a production record's
    ``argument_bytes``, beside its traced temporaries) against the same sum
    over the reference's specs and ``jax.eval_shape`` trees, for every input
    shape the policy keeps, on both production meshes and on 1x1."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    for M, prod in ((M16, make_production_mesh()), (M2x16, make_production_mesh(multi_pod=True)),
                    (M1, MeshSpec(("data", "model"), (1, 1)))):
        jo, opts = jax_default_opts(jcfg, M()), default_opts(cfg, prod)
        jps = _params(arch, M.shape["model"])[1]
        jpspec = jax_param_specs(jcfg, jo, jps, M())
        for name, shape in INPUT_SHAPES.items():
            if shape_skip_reason(cfg, name, False):
                continue
            jshape = JAX_SHAPES[name]
            jb = jax_input_specs(jcfg, jshape, jo)
            bspec = jax_batch_specs(jcfg, jshape.mode, jshape.global_batch, M())
            want = _jax_bytes(jps, jpspec, M()) + _jax_bytes(jb, bspec, M())
            if jshape.mode == "train":
                mspec = jax_zero1_specs(jpspec, jps, M())
                want += _jax_bytes(jax_opt_shapes(jps), {"step": P(), "m": mspec, "v": mspec},
                                   M())
            elif jshape.mode == "decode":
                jcsh = jax_cache_shapes(jcfg, jo, jshape)
                want += _jax_bytes(jcsh, jax_cache_specs(jcfg, jo, jcsh, M(),
                                                         batch=jshape.global_batch,
                                                         seq=jshape.seq_len), M())
            assert reckon_argument_bytes(cfg, opts, shape, prod) == want, (name, prod)


def test_constrain_leaves_a_plain_tensor_and_lays_out_a_dtensor(one_rank_group):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh

    x = torch.arange(24.0).reshape(4, 6)
    assert constrain(x, ("model", None)) is x
    assert constrain(x, None) is x
    mesh = make_host_mesh(device="cpu")
    assert tuple(mesh.mesh_dim_names) == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert to_placements(("model", None), mesh) == [Replicate(), Shard(0)]
    assert to_placements(("data", "model"), mesh) == [Shard(0), Shard(1)]
    assert to_placements((None, None), mesh) == [Replicate(), Replicate()]
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    out = constrain(d, ("data", "model"))
    assert isinstance(out, DTensor) and list(out.placements) == [Shard(0), Shard(1)]
    assert torch.equal(out.full_tensor(), x)
    mesh3 = make_host_mesh(pod=1, device="cpu")
    assert tuple(mesh3.mesh_dim_names) == ("pod", "data", "model")
    assert to_placements((("pod", "data"), None, "model"), mesh3) == [Shard(0), Shard(0),
                                                                      Shard(2)]


def test_layout_options_are_refused_until_a_dtensor_reaches_the_model(tmp_path, capsys):
    """A DTensor reaches the model now, so ``act_spec`` and
    ``moe_constrain`` are refused no more: on plain tensors a forward with
    either (or with ``default_opts``' sequence-parallel spec for 16x16) is
    the forward without them, bit for bit, and the dry run takes
    ``--seq-parallel`` and ``--moe-constrain``, tracing the record with
    both layouts (its opts and collectives written to its file)."""
    import json

    from repro_torch.configs import reduced
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T

    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    base = default_opts(cfg, remat=False)
    params = T.init_params(cfg, base, seed=0, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    want = T.forward_prefill(cfg, base, params, {"tokens": tok})
    assert torch.isfinite(want).all()
    for opts in (dataclasses.replace(base, act_spec=("data", "model", None)),
                 dataclasses.replace(base, moe_constrain=True),
                 dataclasses.replace(default_opts(cfg, MESHES["16x16"](), seq_parallel=True,
                                                  remat=False), kv_mult=1, expert_pad_to=1)):
        assert opts.act_spec is not None or opts.moe_constrain
        assert torch.equal(T.forward_prefill(cfg, opts, params, {"tokens": tok}), want)
    assert not hasattr(T, "LAYOUT_REFUSED") and not hasattr(D, "LAYOUTS_REFUSED")
    assert not hasattr(D, "NOT_TRACED")
    D.main(["--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k", "--seq-parallel",
            "--moe-constrain", "--out", str(tmp_path)])
    summary = capsys.readouterr().out  # the children print the record's own line
    assert "dry run: 1 records" in summary and ", 0 failed" in summary
    rec = json.loads((tmp_path / "qwen2-moe-a2.7b__decode_32k__16x16.json").read_text())
    assert rec["seq_parallel"] and rec["moe_constrain"] and rec["collectives"]


def test_mesh_spec_sizes():
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert make_production_mesh().size == 256
    assert MeshSpec(("data", "model"), (1, 1)).size == 1
