"""zamba2-7b's training path against the JAX package's: ``mamba2`` blocks
under autograd (the chunked SSD scan) and the shared attention block, one
parameter copy whose gradient is summed over its occurrences, in fp32 on
the CPU. The model is reduced zamba2-7b with its pattern cut to (mamba2,
shared_attn), repeated three times, and its tail mamba2 block: the shared
block occurs three times. Both sides start from the reference's parameters
converted with ``lm_from_jax`` (the reference draws the shared block from a
``hash``-salted key, ROADMAP C15, so every bar here holds for any draw) and
one ``token_batches`` batch of 2 x 128 tokens (two chunks of the scan).

Bars: the loss within 1e-5 relative and every gradient leaf within 1e-4 of
that leaf's max |g| against ``jax.value_and_grad`` of the reference's
``forward_train``, at each ``remat`` and ``ssm_seq_chunk`` (0 and 16);
the chunked scan sums in another order than the reference's sequential
``lax.scan``, so they agree to fp32 noise, not bit for bit. One
``make_train_step``'s loss (1e-5) and grad norm (1e-4) against the
reference's. The port alone: the loss through ``fused_softmax_xent``
against the plain loss, the shared block's gradient against the sum of an
untied copy's per occurrence (1e-6 of max |g|), finite gradients at strong
decay, and ``train_lm`` with ``remat`` and ``checkpoint=``."""
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.configs.base import BlockKind as JaxBlockKind
from repro.data.loader import token_batches as jax_token_batches
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import ModelOpts as JaxOpts
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import BlockKind
from repro_torch.convert import lm_adamw_from_jax, lm_from_jax
from repro_torch.data.loader import token_batches
from repro_torch.launch.steps import default_opts, make_train_step
from repro_torch.launch.train import range_times, stub_inputs, train_lm
from repro_torch.models.transformer import ModelOpts, forward_train, init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map, value_and_grad

B, S = 2, 128


def _cut(cfg, kind):
    """(mamba2, shared_attn) x 3 + the tail mamba2 block."""
    m, s = kind("mamba2"), kind("shared_attn", shared=True)
    return replace(cfg, pattern=(m, s), n_repeats=3, tail_blocks=(m,), num_layers=7)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(jcfg, cfg, the reference's params as numpy, one batch)."""
    jcfg = _cut(jax_reduced(jax_get_arch("zamba2-7b")), JaxBlockKind)
    cfg = _cut(reduced(get_arch("zamba2-7b")), BlockKind)
    init = jax.jit(lambda key: jax_init_params(key, jcfg, JaxOpts(remat=False)))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    batch = next(jax_token_batches(np.random.default_rng(0), jcfg.vocab_size, B, S))
    return jcfg, cfg, jp, batch


@pytest.fixture(scope="module")
def reference(setup):
    """(remat, ssm_seq_chunk) -> the reference's loss and gradient leaves
    in the port's layout, each setting compiled once for the module."""
    jcfg, _, jp, batch = setup
    params, jb = jax.tree.map(jnp.asarray, jp), _jax_batch(batch)
    done = {}

    def get(remat, chunk):
        if (remat, chunk) not in done:
            jo = JaxOpts(remat=remat, attn_chunk=0, ssm_seq_chunk=chunk)
            vg = jax.jit(jax.value_and_grad(lambda p, b: jax_forward_train(jcfg, jo, p, b),
                                            has_aux=True))
            (loss, _), g = vg(params, jb)
            done[(remat, chunk)] = (float(loss),
                                    tree_leaves(lm_from_jax(jax.tree.map(np.asarray, g))))
        return done[(remat, chunk)]

    return get


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _opts(**kw):
    return ModelOpts(**{"attn_chunk": 0, "remat": False, **kw})


def _grads(cfg, opts, params, batch):
    return value_and_grad(lambda p: forward_train(cfg, opts, p, _torch_batch(batch))[0],
                          params)


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_the_reference(setup, reference, remat, chunk):
    _, cfg, jp, batch = setup
    want_loss, want = reference(remat, chunk)
    loss, g = _grads(cfg, _opts(remat=remat, ssm_seq_chunk=chunk), lm_from_jax(jp), batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = tree_leaves(g)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
    shared = tree_leaves(g["shared"]["shared_attn"])
    assert len(shared) == 9 and all(t.abs().max() > 0 for t in shared)
    assert g["unit"]["blk0"]["mamba"]["A_log"].abs().max() > 0


def test_train_step_matches_the_reference(setup):
    """One make_train_step with the repeats checkpointed, as the
    reference's ``default_opts``: loss 1e-5 relative, grad norm 1e-4."""
    jcfg, cfg, jp, batch = setup
    jo = JaxOpts(remat=True, attn_chunk=0)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jax_adamw_init(jparams)
    step = jax.jit(jax_make_train_step(jcfg, jo, lr=1e-2))
    _, _, wm = step(jparams, jstate, _jax_batch(batch))
    state = lm_adamw_from_jax(jax.tree.map(np.asarray, jstate))
    _, _, m = make_train_step(cfg, _opts(remat=True), lr=1e-2)(lm_from_jax(jp), state,
                                                               _torch_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]), rtol=1e-4)


def test_loss_through_the_kernel_path_matches_the_plain_loss(setup):
    """``use_kernels``: the LM loss through ``ops.fused_softmax_xent`` (its
    plain version on the CPU), loss 1e-5 relative and gradients 1e-5 of
    max |g| against the plain loss."""
    _, cfg, jp, batch = setup
    params = lm_from_jax(jp)
    plain_loss, plain = _grads(cfg, _opts(), params, batch)
    loss, g = _grads(cfg, _opts(use_kernels=True), params, batch)
    np.testing.assert_allclose(float(loss), float(plain_loss), rtol=1e-5)
    for a, b in zip(tree_leaves(plain), tree_leaves(g)):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()


@pytest.mark.parametrize("remat", [False, True])
def test_shared_gradient_is_the_sum_over_its_occurrences(setup, remat):
    """The tied model's shared-block gradient against an untied model's:
    the same block kind unshared, its three copies stacked in the unit,
    each holding the shared values. The forward is the same; the untied
    gradient of each copy is one occurrence's, and their sum is the tied
    gradient within 1e-6 of max |g|. Every other leaf agrees too."""
    _, cfg, jp, batch = setup
    tied = lm_from_jax(jp)
    untied_cfg = replace(cfg, pattern=(cfg.pattern[0], BlockKind("shared_attn")))
    copies = tree_map(lambda t: t.expand((cfg.n_repeats,) + t.shape).clone(),
                      tied["shared"]["shared_attn"])
    untied = {**tied, "shared": {}, "unit": {**tied["unit"], "blk1": copies}}
    opts = _opts(remat=remat)
    loss, g = _grads(cfg, opts, tied, batch)
    loss_u, gu = _grads(untied_cfg, opts, untied, batch)
    assert float(loss) == float(loss_u)
    summed = [t.sum(0) for t in tree_leaves(gu["unit"]["blk1"])]
    for a, b in zip(tree_leaves(g["shared"]["shared_attn"]), summed):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()
    rest = {k: v for k, v in g.items() if k not in ("shared", "unit")}
    rest_u = {k: v for k, v in gu.items() if k not in ("shared", "unit")}
    for a, b in zip(tree_leaves((rest, g["unit"]["blk0"])),
                    tree_leaves((rest_u, gu["unit"]["blk0"]))):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


def test_gradients_stay_finite_at_strong_decay(setup):
    """Decays that underflow: dt about 20 and A from -1 to -16 make log a
    -20 to -320 a step, so exp of a chunk's segment sums is 0 for nearly
    every pair off the diagonal, and the masked pairs (exp of -inf) give
    zero gradients, not NaN. The sequence chunked by 16 gives the same
    gradients within 1e-4 of each leaf's max |g|, or of 1e-9 of the largest
    leaf's for the decay parameters, whose gradient is then the residue of
    underflowed terms (about 1e-12 of the others')."""
    _, cfg, jp, batch = setup
    params = lm_from_jax(jp)
    for blk in [params["unit"]["blk0"], *params["tail_blocks"]]:
        blk["mamba"]["dt_bias"] = torch.full_like(blk["mamba"]["dt_bias"], 20.0)
    loss, g = _grads(cfg, _opts(), params, batch)
    loss_c, gc = _grads(cfg, _opts(ssm_seq_chunk=16), params, batch)
    assert torch.isfinite(loss) and all(torch.isfinite(t).all() for t in tree_leaves(g))
    np.testing.assert_allclose(float(loss_c), float(loss), rtol=1e-5)
    floor = 1e-9 * max(t.abs().max() for t in tree_leaves(g))
    for a, b in zip(tree_leaves(g), tree_leaves(gc)):
        assert (a - b).abs().max() <= 1e-4 * max(a.abs().max(), floor)


def test_train_lm_with_remat_on_cpu():
    """``train_lm(remat=True)`` recomputes each repeat: on the CPU the
    same losses and grad norms as without, bit for bit."""
    runs = [train_lm("zamba2-7b", steps=2, batch=2, seq=16, remat=remat, device="cpu")
            for remat in (False, True)]
    assert np.isfinite(runs[1].losses + runs[1].grad_norms).all()
    assert runs[0].losses == runs[1].losses and runs[0].grad_norms == runs[1].grad_norms


def test_train_lm_checkpoint_round_trips_the_shared_block(tmp_path):
    """``train_lm(checkpoint=)`` on reduced zamba2-7b: the file, read by
    the reference's loader, has the reference's layout (its
    ``init_params`` / ``adamw_init`` leaves, paths, shapes and dtypes) and holds,
    bit for bit, the shared block and its AdamW moments that the same two
    steps give when taken here."""
    path = str(tmp_path / "zamba2.msgpack")
    kw = dict(steps=2, batch=2, seq=16, remat=True)
    train_lm("zamba2-7b", checkpoint=path, device="cpu", **kw)
    back = jax_load_pytree(path)
    jcfg = jax_reduced(jax_get_arch("zamba2-7b"))
    want = jax.eval_shape(lambda: {"params": (p := jax_init_params(
        jax.random.PRNGKey(0), jcfg, JaxOpts())), "opt": jax_adamw_init(p)})
    def layout(tree):  # an empty list (``head_blocks``) holds no leaf to write
        return {jax.tree_util.keystr(k): (a.shape, str(a.dtype))
                for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert layout(back) == layout(want)
    # the same two steps, taken here
    cfg = reduced(get_arch("zamba2-7b"))
    opts = default_opts(cfg, attn_chunk=0, remat=True)
    params = init_params(cfg, opts, seed=0, device="cpu")
    state = adamw_init(params)
    step = make_train_step(cfg, opts, lr=1e-3)
    gen = token_batches(np.random.default_rng(0), cfg.vocab_size, kw["batch"], kw["seq"])
    for _ in range(kw["steps"]):
        b = {k: torch.from_numpy(v).long() for k, v in next(gen).items()}
        params, state, _ = step(params, state, {**b, **stub_inputs(cfg, kw["batch"], "cpu")})
    loaded = lm_from_jax(back["params"]["shared"])
    moments = lm_adamw_from_jax(back["opt"])
    assert int(moments["step"]) == kw["steps"]
    for got, ref in ((loaded, params["shared"]), (moments["m"]["shared"], state["m"]["shared"]),
                     (moments["v"]["shared"], state["v"]["shared"])):
        # the file's dicts come back in sorted key order: pair the leaves by key
        assert all(tree_leaves(tree_map(torch.equal, ref, got)))


def test_range_times_count_each_kernel_under_its_outermost_range():
    """``train_lm``'s profile groups device time by ``record_function``
    range: a CPU op's kernels go to the outermost annotation above it, a
    kernel outside every range to none, and an annotation's own span on
    the device is not a kernel."""
    def ev(name, parent=None, kernels=(), annotation=False):
        return SimpleNamespace(name=name, cpu_parent=parent, is_user_annotation=annotation,
                               kernels=[SimpleNamespace(duration=d) for d in kernels])

    outer = ev("mamba2_block", annotation=True)
    inner = ev("inner", parent=outer, annotation=True)
    events = [outer, inner,
              ev("aten::mul", parent=inner, kernels=(10.0, 20.0)),
              ev("aten::add", parent=outer, kernels=(30.0,)),
              ev("aten::exp", kernels=(1000.0,)),
              ev("other", annotation=True, kernels=(500.0,)),
              ev("aten::sum", parent=ev("other", annotation=True), kernels=(4.0,))]
    assert range_times(events, steps=2) == pytest.approx({"mamba2_block": 30e-6,
                                                          "other": 2e-6})
