"""The port's LM training path against the JAX package's, on reduced
llama3.2-3b in fp32: ``forward_train``'s loss, one ``make_train_step``'s
gradients, gradient norm, parameters and AdamW state, with the LM loss on
the plain path (``use_kernels=False``) and through ``fused_softmax_xent``
(``use_kernels=True``; Pallas in interpret mode on the JAX side). Also the
modules the path runs: ``mha``, ``clip_by_global_norm``, the schedules and
the batch loaders. Both sides start from the reference's parameters
converted with ``lm_from_jax`` and the same ``token_batches`` batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data.loader import BatchLoader as JaxBatchLoader
from repro.data.loader import token_batches as jax_token_batches
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import ModelOpts as JaxOpts
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models.attention import mha as jax_mha
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import linear_warmup_cosine as jax_warmup_cosine
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_adamw_from_jax, lm_adamw_to_jax, lm_from_jax, lm_to_jax
from repro_torch.data.loader import BatchLoader, token_batches
from repro_torch.kernels import ops
from repro_torch.launch.steps import default_opts, make_train_step
from repro_torch.launch.train import train_lm
from repro_torch.models.attention import mha
from repro_torch.models.transformer import ModelOpts, forward_train, init_params
from repro_torch.optim import (
    adamw_init,
    adamw_update_,
    clip_by_global_norm,
    cosine_schedule,
    linear_warmup_cosine,
)
from repro_torch.tree import tree_leaves, tree_map, value_and_grad

ARCH = "llama3.2-3b"
B, S, LR = 2, 16, 1e-2


@pytest.fixture(scope="module")
def setup():
    """(jcfg, cfg, jax params as numpy, one token_batches batch)."""
    jcfg = jax_reduced(jax_get_arch(ARCH))
    jp = jax.tree.map(np.asarray,
                      jax_init_params(jax.random.PRNGKey(0), jcfg, JaxOpts(remat=False)))
    batch = next(jax_token_batches(np.random.default_rng(0), jcfg.vocab_size, B, S))
    return jcfg, reduced(get_arch(ARCH)), jp, batch


def _opts(use_kernels, **kw):
    """train_lm's options on both sides."""
    kw = {"attn_chunk": 0, "remat": False, "use_kernels": use_kernels, **kw}
    return JaxOpts(**kw), ModelOpts(**kw)


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# fp32 through one layer and a 512-wide vocabulary: sums in other orders
@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_train_loss(setup, use_kernels):
    jcfg, cfg, jp, batch = setup
    jo, to = _opts(use_kernels)
    want, waux = jax_forward_train(jcfg, jo, jax.tree.map(jnp.asarray, jp), _jax_batch(batch))
    got, aux = forward_train(cfg, to, lm_from_jax(jp), _torch_batch(batch))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(waux["ce"]), rtol=1e-5)
    assert float(aux["lb_loss"]) == float(waux["lb_loss"]) == 0.0


@pytest.mark.parametrize("use_kernels", [False, True])
def test_gradients(setup, use_kernels):
    """Every gradient leaf within 1e-4 of that leaf's max |g|."""
    jcfg, cfg, jp, batch = setup
    jo, to = _opts(use_kernels)
    jb = _jax_batch(batch)
    wg = jax.grad(lambda p: jax_forward_train(jcfg, jo, p, jb)[0])(
        jax.tree.map(jnp.asarray, jp))
    _, g = value_and_grad(lambda p: forward_train(cfg, to, p, _torch_batch(batch))[0],
                          lm_from_jax(jp))
    for a, b in zip(tree_leaves(lm_from_jax(jax.tree.map(np.asarray, wg))), tree_leaves(g)):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


def test_gradients_of_stacked_repeats():
    """Three repeats of the unit: each stacked leaf's gradient (one slice
    per repeat) within 1e-4 of its max |g|, and the loss within 1e-5."""
    from dataclasses import replace

    jcfg = replace(jax_reduced(jax_get_arch(ARCH)), n_repeats=3, num_layers=3)
    cfg = replace(reduced(get_arch(ARCH)), n_repeats=3, num_layers=3)
    jo, to = _opts(False)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(1), jcfg, jo))
    batch = next(jax_token_batches(np.random.default_rng(1), jcfg.vocab_size, B, S))
    jb = _jax_batch(batch)
    wl, wg = jax.value_and_grad(lambda p: jax_forward_train(jcfg, jo, p, jb)[0])(
        jax.tree.map(jnp.asarray, jp))
    loss, g = value_and_grad(lambda p: forward_train(cfg, to, p, _torch_batch(batch))[0],
                             lm_from_jax(jp))
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    assert g["unit"]["blk0"]["mlp"]["up"].shape[0] == 3
    for a, b in zip(tree_leaves(lm_from_jax(jax.tree.map(np.asarray, wg))), tree_leaves(g)):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_step(setup, use_kernels):
    """One step from the same params, state and batch: loss 1e-5 relative,
    grad norm 1e-4 relative; params and moments within 1e-5 wherever |g| >
    1e-6 (where |g| is near AdamW's eps, the first step moves a parameter
    by about lr * sign(g), and a sign of fp32 noise can flip: ROADMAP C4)."""
    jcfg, cfg, jp, batch = setup
    jo, to = _opts(use_kernels)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jax_adamw_init(jparams)
    wp, ws, wm = jax_make_train_step(jcfg, jo, lr=LR)(jparams, jstate, _jax_batch(batch))
    wg = jax.grad(lambda p: jax_forward_train(jcfg, jo, p, _jax_batch(batch))[0])(jparams)

    params = lm_from_jax(jp)
    state = lm_adamw_from_jax(jax.tree.map(np.asarray, jstate))
    p, st, m = make_train_step(cfg, to, lr=LR)(params, state, _torch_batch(batch))
    assert p is params and st is state  # updated in place
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(wm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]), rtol=1e-4)
    assert int(st["step"]) == int(ws["step"]) == 1

    big = [np.abs(np.asarray(a)) > 1e-6 for a in jax.tree.leaves(wg)]
    got = {"params": lm_to_jax(p), **lm_adamw_to_jax(st)}
    for name, want in (("params", wp), ("m", ws["m"]), ("v", ws["v"])):
        for a, b, keep in zip(jax.tree.leaves(want), jax.tree.leaves(got[name]), big):
            a = np.asarray(a)
            assert a.shape == b.shape and keep.any()
            np.testing.assert_allclose(b[keep], a[keep], rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_curve_over_five_steps_matches_the_reference(setup, use_kernels):
    """ROADMAP C10: five ``make_train_step`` steps at ``train_lm``'s lr
    (1e-3) in each package, from the same params and AdamW state, on the
    same ``token_batches`` stream. Loss 1e-5 relative at step 1 and 1e-4
    after (C4: AdamW's steps carry the gradients' fp32 noise forward); the
    curves also rise and fall at the same steps, so a loss that rises after
    a step, as at full width, is the reference's behaviour."""
    jcfg, cfg, jp, _ = setup
    jo, to = _opts(use_kernels)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jax_adamw_init(jparams)
    jstep = jax.jit(jax_make_train_step(jcfg, jo, lr=1e-3))
    params = lm_from_jax(jp)
    state = lm_adamw_from_jax(jax.tree.map(np.asarray, jstate))
    step = make_train_step(cfg, to, lr=1e-3)
    jb = jax_token_batches(np.random.default_rng(0), jcfg.vocab_size, B, S)
    tb = token_batches(np.random.default_rng(0), cfg.vocab_size, B, S)
    want, got = [], []
    for _ in range(5):
        jparams, jstate, wm = jstep(jparams, jstate, _jax_batch(next(jb)))
        params, state, m = step(params, state, _torch_batch(next(tb)))
        want.append(float(wm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
    assert np.array_equal(np.sign(np.diff(got)), np.sign(np.diff(want)))
    assert want[1] > want[0]  # the reference's own loss rises at step 2 here


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def test_remat_changes_nothing_in_the_forward(setup):
    """Checkpointed repeats recompute the same ops: the loss is bitwise the
    same, and so are the gradients."""
    _, cfg, jp, batch = setup
    out = []
    for remat in (False, True):
        _, to = _opts(True, remat=remat)
        out.append(value_and_grad(lambda p: forward_train(cfg, to, p, _torch_batch(batch))[0],
                                  lm_from_jax(jp)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def test_loss_through_the_kernel_op(setup, monkeypatch):
    """use_kernels sends each loss chunk through ops.fused_softmax_xent once:
    S / loss_chunk calls, each on (B * chunk, V_pad) logits."""
    _, cfg, jp, batch = setup
    _, to = _opts(True, loss_chunk=4)
    shapes = []
    real = ops.fused_softmax_xent

    def spy(logits, labels):
        shapes.append(tuple(logits.shape))
        return real(logits, labels)

    monkeypatch.setattr(ops, "fused_softmax_xent", spy)
    forward_train(cfg, to, lm_from_jax(jp), _torch_batch(batch))
    assert shapes == [(B * 4, 512)] * (S // 4)


@pytest.mark.parametrize("attn_chunk", [0, 8])
def test_attn_chunk_in_training(setup, attn_chunk):
    jcfg, cfg, jp, batch = setup
    jo, to = _opts(False, attn_chunk=attn_chunk)
    want, _ = jax_forward_train(jcfg, jo, jax.tree.map(jnp.asarray, jp), _jax_batch(batch))
    got, _ = forward_train(cfg, to, lm_from_jax(jp), _torch_batch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_train_lm_on_cpu():
    res = train_lm(ARCH, steps=3, batch=2, seq=16, log_every=1, device="cpu")
    assert len(res.losses) == len(res.grad_norms) == len(res.step_s) == 3
    assert np.isfinite(res.losses).all() and res.tokens_per_step == 32


def test_default_opts_are_the_reference_defaults():
    opts = default_opts(reduced(get_arch(ARCH)))
    assert (opts.kv_mult, opts.attn_chunk, opts.remat, opts.loss_chunk,
            opts.use_kernels) == (1, 1024, True, 512, False)
    assert default_opts(None, remat=False, use_kernels=True).use_kernels
    j = JaxOpts()
    t = ModelOpts()
    assert (t.attn_chunk, t.remat, t.loss_chunk, t.use_kernels, t.rwkv_chunk,
            t.ssm_seq_chunk) == (j.attn_chunk, j.remat, j.loss_chunk, j.use_kernels,
                                 j.rwkv_chunk, j.ssm_seq_chunk) == (0, True, 512, False, 0, 0)
    assert (opts.rwkv_chunk, opts.ssm_seq_chunk) == (0, 0)
    # the reference pads routed experts to its mesh's model-parallel size:
    # one device here
    assert opts.expert_pad_to == t.expert_pad_to == j.expert_pad_to == 1


@pytest.mark.parametrize("remat", [False, True])
def test_mla_forward_train_matches_the_reference(remat):
    """Reduced deepseek-v2-lite-16b (an ``mla`` layer with a dense MLP, an
    ``mla_moe`` layer whose router losses join the loss), fp32, its
    attention the expanded form through ``mha``: the loss within 1e-5
    relative and every gradient leaf, the router's included, within 1e-4
    of that leaf's max |g| against ``jax.value_and_grad``, with the repeats
    checkpointed and not."""
    arch = "deepseek-v2-lite-16b"
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    jp = jax.tree.map(np.asarray,
                      jax_init_params(jax.random.PRNGKey(2), jcfg, JaxOpts(remat=False)))
    batch = next(jax_token_batches(np.random.default_rng(2), jcfg.vocab_size, B, S))
    jo, to = _opts(False, remat=remat)
    jb = _jax_batch(batch)
    (want, _), wg = jax.value_and_grad(lambda p: jax_forward_train(jcfg, jo, p, jb),
                                       has_aux=True)(jax.tree.map(jnp.asarray, jp))
    loss, g = value_and_grad(lambda p: forward_train(cfg, to, p, _torch_batch(batch))[0],
                             lm_from_jax(jp))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    want_g = tree_leaves(lm_from_jax(jax.tree.map(np.asarray, wg)))
    got_g = tree_leaves(g)
    assert len(want_g) == len(got_g)
    for a, b in zip(want_g, got_g):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
    assert g["unit"]["blk0"]["moe"]["router"].abs().max() > 0
    assert g["head_blocks"][0]["mla"]["w_uk"].abs().max() > 0


def test_training_a_block_kind_the_port_lacks_raises():
    """Every block kind of the reference trains: rwkv6
    (tests/test_torch_rwkv6_train.py), local_attn and moe
    (tests/test_torch_train_families.py), mla and mla_moe (above), mamba2
    and the shared block (tests/test_torch_zamba2_train.py). A kind the
    reference does not know raises ``ValueError``, naming the kinds, as a
    frontend it does not know does."""
    from dataclasses import replace

    from repro_torch.configs.base import BlockKind

    cfg = reduced(get_arch("zamba2-7b"))
    params = init_params(cfg, ModelOpts(), device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    loss, _ = forward_train(cfg, ModelOpts(), params, {"tokens": tok, "labels": tok})
    assert torch.isfinite(loss)
    unknown = replace(cfg, pattern=(BlockKind("mamba3"),), n_repeats=1, tail_blocks=(),
                      num_layers=1)
    with pytest.raises(ValueError, match="unknown block kind 'mamba3'"):
        forward_train(unknown, ModelOpts(), params, {"tokens": tok, "labels": tok})
    with pytest.raises(ValueError, match="unknown frontend"):
        forward_train(replace(cfg, frontend="video_stub"), ModelOpts(), params,
                      {"tokens": tok, "labels": tok})


def test_checkpoint_option_is_not_ported(tmp_path):
    """Named when ``checkpoint=`` raised (ROADMAP A4, now ported): the
    option writes {"params", "opt"} after the run, and the file reads back
    through the reference's converter to what ``lm_from_jax`` /
    ``lm_adamw_from_jax`` turn into the same tensors (a step's worth of
    AdamW state, step counter 1)."""
    from repro_torch.checkpoint import load_pytree

    path = str(tmp_path / "ckpt.msgpack")
    res = train_lm(ARCH, steps=1, batch=1, seq=8, checkpoint=path, device="cpu")
    back = load_pytree(path)
    params = lm_from_jax(back["params"])
    state = lm_adamw_from_jax(back["opt"])
    assert int(state["step"]) == 1
    assert sum(t.numel() for t in tree_leaves(params)) == res.n_params
    assert all(torch.isfinite(t).all() for t in tree_leaves((params, state["m"], state["v"])))


@pytest.mark.parametrize("steps,profile_last", [(1, 1), (3, 3), (2, -1)])
def test_profile_last_leaves_an_unprofiled_step(steps, profile_last):
    """The profiled steps' idle share is taken against the wall time of the
    step before them, so at least one step runs unprofiled."""
    with pytest.raises(ValueError, match="profile_last"):
        train_lm(ARCH, steps=steps, profile_last=profile_last, device="cpu")


# --- modules -----------------------------------------------------------------


# (B, Sq, Sk, N, K, H, causal, window, chunk, valid_len, q_offset)
MHA_CASES = [
    (2, 16, 16, 4, 2, 8, True, 0, 0, None, 0),
    (2, 16, 16, 4, 2, 8, True, 0, 4, None, 0),
    (1, 12, 12, 6, 2, 8, True, 5, 0, None, 0),
    (1, 12, 12, 6, 2, 8, True, 5, 3, None, 0),
    (2, 1, 20, 4, 1, 8, True, 0, 5, 9, 8),
    (2, 1, 20, 4, 4, 8, True, 6, 0, 14, 13),
    (1, 8, 8, 2, 2, 8, False, 0, 4, None, 0),
    (1, 4, 16, 4, 2, 8, True, 3, 4, None, 14),  # rows past the window's end see no key
]


@pytest.mark.parametrize("case", MHA_CASES)
def test_mha_matches_jax(case):
    """fp32 within 1e-6: softmax of the same scores in other orders."""
    B_, Sq, Sk, N, K, H, causal, window, chunk, valid_len, q_offset = case
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B_, Sq, N, H), (B_, Sk, K, H), (B_, Sk, K, H)))
    qpos, kpos = np.arange(Sq) + q_offset, np.arange(Sk)
    kw = dict(causal=causal, window=window, chunk=chunk, valid_len=valid_len)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos), **kw)
    got = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
              q_positions=torch.from_numpy(qpos), k_positions=torch.from_numpy(kpos), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", [MHA_CASES[1], MHA_CASES[2], MHA_CASES[7]])
def test_mha_gradient_matches_jax(case):
    """The q, k, v gradients of a random cotangent, through the one-block
    and the chunked softmax, within 1e-5 (fp32)."""
    B_, Sq, Sk, N, K, H, causal, window, chunk, valid_len, q_offset = case
    rng = np.random.default_rng(1)
    q, k, v, ct = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B_, Sq, N, H), (B_, Sk, K, H), (B_, Sk, K, H), (B_, Sq, N, H)))
    qpos, kpos = np.arange(Sq) + q_offset, np.arange(Sk)
    kw = dict(causal=causal, window=window, chunk=chunk, valid_len=valid_len)
    _, vjp = jax.vjp(lambda q, k, v: jax_mha(q, k, v, q_positions=jnp.asarray(qpos),
                                             k_positions=jnp.asarray(kpos), **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(ct))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = mha(*ins, q_positions=torch.from_numpy(qpos), k_positions=torch.from_numpy(kpos),
              **kw)
    got = torch.autograd.grad(out, ins, torch.from_numpy(ct))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((4, 3)) * 3).astype(np.float32),
            "blocks": [{"s": rng.standard_normal((5,)).astype(np.float32)}],
            "b": rng.standard_normal((3,)).astype(np.float32)}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    """fp32 within 1e-6 relative: the same sum of squares in other orders."""
    g = _grad_tree(0)
    want, wn = jax_clip(jax.tree.map(jnp.asarray, g), max_norm)
    got, gn = clip_by_global_norm(tree_map(torch.from_numpy, g), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(_np(got))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=0)
    if max_norm > float(wn):  # no clipping: the leaves pass through unchanged
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(g),
                                                        jax.tree.leaves(_np(got))))


def test_clip_keeps_each_leaf_dtype():
    g = {"a": torch.ones(4, dtype=torch.bfloat16) * 3, "b": torch.ones(4)}
    out, gn = clip_by_global_norm(g, 1.0)
    assert out["a"].dtype == torch.bfloat16 and gn.dtype == torch.float32
    np.testing.assert_allclose(float(gn), np.sqrt(40.0), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 3, 10, 57, 100, 250])
def test_schedules_match_jax(step):
    """fp32 (the reference) against double (a Python step) or fp32 (a
    tensor step): within 1e-6 relative."""
    kw = dict(base_lr=3e-4, total_steps=200, min_frac=0.1)
    wkw = dict(base_lr=3e-4, warmup=20, total_steps=200)
    for s in (step, torch.tensor(float(step))):
        np.testing.assert_allclose(float(cosine_schedule(s, **kw)),
                                   float(jax_cosine(step, **kw)), rtol=1e-6)
        np.testing.assert_allclose(float(linear_warmup_cosine(s, **wkw)),
                                   float(jax_warmup_cosine(step, **wkw)), rtol=1e-6)


def test_batch_loader_matches_jax_exactly():
    x = np.arange(50 * 3).reshape(50, 3).astype(np.float32)
    y = np.arange(50)
    a, b = BatchLoader(x, y, 16, seed=3), JaxBatchLoader(x, y, 16, seed=3)
    for _ in range(10):  # across several epoch reshuffles
        (xa, ya), (xb, yb) = a.next(), b.next()
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


def test_token_batches_match_jax_exactly():
    a = token_batches(np.random.default_rng(5), 300, 3, 20)
    b = jax_token_batches(np.random.default_rng(5), 300, 3, 20)
    for _ in range(3):
        ba, bb = next(a), next(b)
        for k in ("tokens", "labels"):
            assert ba[k].dtype == bb[k].dtype == np.int32
            assert np.array_equal(ba[k], bb[k])
        assert np.array_equal(ba["tokens"][:, 1:], ba["labels"][:, :-1])


def _reference_adamw(g, m, v, p, t, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """The reference's per-leaf AdamW expression (``repro.optim.optimizers``),
    transcribed term for term in torch."""
    bc1, bc2 = 1.0 - b1**t, 1.0 - b2**t
    g = g.to(torch.float32)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    wd = weight_decay if p.ndim >= 2 else 0.0
    pf = p.to(torch.float32)
    return (pf - lr * (delta + wd * pf)).to(p.dtype), m, v


def test_adamw_in_place_is_the_reference_expression_bit_for_bit():
    """adamw_update_ writes the reference's values, bit for bit, into the
    leaves it is given (fp32 and bf16 params)."""
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
         "n": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
         "h": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)).bfloat16()}
    want = [(t.clone(), torch.zeros(t.shape), torch.zeros(t.shape)) for t in tree_leaves(p)]
    state = adamw_init(p)
    for i in range(3):
        g = tree_map(lambda t: torch.from_numpy(
            rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(t.dtype), p)
        t = torch.tensor(float(i + 1))
        want = [_reference_adamw(gl, m, v, pl, t, 1e-2)
                for gl, (pl, m, v) in zip(tree_leaves(g), want)]
        leaves = tree_leaves((p, state["m"], state["v"]))
        q, s_ = adamw_update_(g, state, p, lr=1e-2)
        assert q is p and s_ is state
        assert all(a is b for a, b in zip(leaves, tree_leaves((p, state["m"], state["v"]))))
    assert int(state["step"]) == 3
    for (wp, wm, wv), gp, gm, gv in zip(want, tree_leaves(p), tree_leaves(state["m"]),
                                        tree_leaves(state["v"])):
        assert torch.equal(wp, gp) and torch.equal(wm, gm) and torch.equal(wv, gv)


def test_lm_adamw_state_round_trips(setup):
    _, _, jp, _ = setup
    js = jax.tree.map(np.asarray, jax_adamw_init(jax.tree.map(jnp.asarray, jp)))
    back = lm_adamw_to_jax(lm_adamw_from_jax(js))
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
