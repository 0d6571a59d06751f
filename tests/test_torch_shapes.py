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


class _Mesh16:
    """The reference's 16 x 16 stub (``tests/test_substrates.py``)."""

    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_shapes_at_the_16x16_opts_match_the_reference(arch):
    """Under ``default_opts`` of a 16 x 16 mesh (KV heads replicated where
    GQA grouping survives, ``kv_mult`` 2 for the 8-KV-head models; routed
    experts padded to 16), the params, the moments and a (128, 32768)
    cache are the reference's leaf for leaf."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    jo, opts = jax_default_opts(jcfg, _Mesh16()), default_opts(cfg, _Mesh16())
    assert (opts.kv_mult, opts.expert_pad_to) == (jo.kv_mult, jo.expert_pad_to)
    jparams = jax_param_shapes(jcfg, jo)
    params = param_shapes(cfg, opts)
    assert _layout(params) == _jax_layout(jparams)
    assert _layout(opt_shapes(params)) == _jax_layout(jax_opt_shapes(jparams))
    shape = SimpleNamespace(global_batch=128, seq_len=32768)
    assert _layout(cache_shapes(cfg, opts, 128, 32768)) == _jax_layout(
        jax_cache_shapes(jcfg, jo, shape))


def test_window_cache_sizes_the_local_layers_by_their_window():
    """``window_cache``: gemma3-12b's ``local_attn`` caches hold its 1,024-key
    window and its global layers the whole sequence, as the reference's
    ``init_block_state``; without it every layer holds the sequence."""
    jcfg, cfg = jax_get_arch("gemma3-12b"), get_arch("gemma3-12b")
    assert cfg.sliding_window == 1024
    for seq in (512, 4096):
        jo = jax_default_opts(jcfg, window_cache=True)
        opts = default_opts(cfg, window_cache=True)
        shape = SimpleNamespace(global_batch=BATCH, seq_len=seq)
        got = _layout(cache_shapes(cfg, opts, BATCH, seq))
        assert got == _jax_layout(jax_cache_shapes(jcfg, jo, shape))
        kinds = [b.kind for b in cfg.pattern]
        for i, kind in enumerate(kinds):
            length = got[f"['unit']['blk{i}']['k']"][0][2]
            assert length == (min(seq, 1024) if kind == "local_attn" else seq), (i, kind)
        full = _layout(cache_shapes(cfg, default_opts(cfg), BATCH, seq))
        assert {k[0][2] for k in full.values() if len(k[0]) == 5} == {seq}


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
