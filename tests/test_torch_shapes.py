"""The port's shape helpers against the JAX package's: for every registered
architecture at its full size, ``param_shapes``, ``opt_shapes`` and
``cache_shapes`` give the reference's ``jax.eval_shape`` trees leaf for
leaf (path, shape and dtype), as ``meta`` tensors that hold no storage."""
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.launch.steps import cache_shapes as jax_cache_shapes
from repro.launch.steps import default_opts as jax_default_opts
from repro.launch.steps import opt_shapes as jax_opt_shapes
from repro.launch.steps import param_shapes as jax_param_shapes
from repro_torch.configs import get_arch, list_archs
from repro_torch.device import on_meta
from repro_torch.launch.steps import cache_shapes, default_opts, opt_shapes, param_shapes

BATCH, SEQ = 2, 128


def _jax_layout(tree) -> dict:
    return {jax.tree_util.keystr(k): (tuple(a.shape), str(a.dtype))
            for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _layout(tree, path="") -> dict:
    """The port's tree as ``_jax_layout`` gives the reference's, every leaf
    checked to be a meta tensor."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _layout(tree[key], f"{path}['{key}']").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _layout(t, f"{path}[{i}]").items()}
    if tree is None:
        return {}
    assert tree.is_meta, path
    return {path: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def test_every_architecture_is_registered_on_both_sides():
    assert sorted(list_archs()) == sorted(jax_list_archs())


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_shapes_match_the_reference(arch):
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    jo, opts = jax_default_opts(jcfg), default_opts(cfg)
    jparams = jax_param_shapes(jcfg, jo)
    params = param_shapes(cfg, opts)
    assert _layout(params) == _jax_layout(jparams)
    assert _layout(opt_shapes(params)) == _jax_layout(jax_opt_shapes(jparams))
    shape = SimpleNamespace(global_batch=BATCH, seq_len=SEQ)
    assert _layout(cache_shapes(cfg, opts, BATCH, SEQ)) == _jax_layout(
        jax_cache_shapes(jcfg, jo, shape))
    assert _layout(cache_shapes(cfg, opts, BATCH, SEQ, torch.float32)) == _jax_layout(
        jax_cache_shapes(jcfg, jo, shape, jax.numpy.float32))


def test_shapes_allocate_nothing():
    """A 5.7 B-parameter model's trees on ``meta``: every leaf a meta
    tensor (no storage), the stored count the reference's; and ``on_meta``
    leaves real devices as they were outside it."""
    cfg = get_arch("zamba2-7b")
    params = param_shapes(cfg, default_opts(cfg))
    state = opt_shapes(params)
    leaves, moments = _layout(params), _layout(state)  # each leaf asserted on meta
    assert sum(torch.Size(s).numel() for s, _ in leaves.values()) == 5_737_416_000
    assert len(moments) == 2 * len(leaves) + 1  # m, v and the step counter
    with on_meta():
        t = torch.zeros(3, device="cpu")
    assert t.is_meta and torch.zeros(3, device="cpu").device.type == "cpu"
