"""rwkv6 training in the port against the JAX package, on the CPU: reduced
rwkv6-1.6b, converted with ``lm_from_jax``, at the four
``(rwkv_chunk, ssm_seq_chunk)`` settings: ``forward_train``'s loss and every
gradient leaf, one ``make_train_step`` (loss, grad norm, params, AdamW
state) and a five-step loss curve, as llama's tests do
(``tests/test_torch_train.py``); the levers' conditions, remat, and
``train_lm``. With ``rwkv_chunk`` 0 the time mix runs ``ops.rwkv6_scan``
under autograd (``Rwkv6Scan``, its plain versions here), and with
``ssm_seq_chunk`` its ds0 and a non-zero dsT carry between sequence chunks.
The scan's gradient and the chunked time mix alone are in
``tests/test_torch_rwkv6_grad.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.data.loader import token_batches as jax_token_batches
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import ModelOpts as JaxOpts
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_adamw_from_jax, lm_adamw_to_jax, lm_from_jax, lm_to_jax
from repro_torch.data.loader import token_batches
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train_lm
from repro_torch.models.transformer import ModelOpts, forward_train
from repro_torch.tree import tree_leaves, value_and_grad

ARCH = "rwkv6-1.6b"
B, SEQ, LR = 2, 32, 1e-3  # train_lm's lr
SETTINGS = [(0, 0), (8, 0), (0, 8), (8, 16)]  # (rwkv_chunk, ssm_seq_chunk)


@functools.lru_cache(maxsize=None)
def _jax_init():
    """(jcfg, the reference's reduced rwkv6-1.6b params as numpy)."""
    jcfg = jax_reduced(jax_get_arch(ARCH))
    init = jax.jit(lambda key: jax_init_params(key, jcfg, JaxOpts(remat=False)))
    return jcfg, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


# --- reduced rwkv6-1.6b -----------------------------------------------------------



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a worker, as ``tests/test_torch_isolation.py``:
    the suite's workers share the cores, and one thread per core each
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def setup():
    """(jcfg, cfg, jax params as numpy, one token_batches batch)."""
    jcfg, jp = _jax_init()
    batch = next(jax_token_batches(np.random.default_rng(0), jcfg.vocab_size, B, SEQ))
    return jcfg, reduced(get_arch(ARCH)), jp, batch


def _opts(rwkv_chunk, ssm_seq_chunk):
    """train_lm's options (attn_chunk=0, remat=False) on both sides."""
    kw = dict(attn_chunk=0, remat=False, rwkv_chunk=rwkv_chunk, ssm_seq_chunk=ssm_seq_chunk)
    return JaxOpts(**kw), ModelOpts(**kw)


@functools.lru_cache(maxsize=None)
def _jax_run(rwkv_chunk, ssm_seq_chunk):
    """The reference at a setting, run once for the tests that share it:
    the loss and gradients on the fixture's batch (the first of
    ``token_batches(default_rng(0))``), then five jitted train steps at lr
    ``LR`` on that stream from fresh AdamW state. Returns numpy trees:
    {"loss", "grads", "step1": (params, state, metrics), "curve"}."""
    jcfg, jp = _jax_init()
    jo, _ = _opts(rwkv_chunk, ssm_seq_chunk)
    jparams = jax.tree.map(jnp.asarray, jp)
    batches = jax_token_batches(np.random.default_rng(0), jcfg.vocab_size, B, SEQ)
    grad = jax.value_and_grad(lambda p, b: jax_forward_train(jcfg, jo, p, b)[0])
    train_step = jax_make_train_step(jcfg, jo, lr=LR)
    # one compiled function a setting: the step and its params' gradients
    step = jax.jit(lambda p, s, b: (grad(p, b), train_step(p, s, b)))
    jstate = jax_adamw_init(jparams)
    out = {"curve": []}
    for i in range(5):
        (loss, grads), (jparams, jstate, m) = step(jparams, jstate, _jax_batch(next(batches)))
        if i == 0:
            out.update(loss=float(loss), grads=jax.tree.map(np.asarray, grads),
                       step1=jax.tree.map(np.asarray, (jparams, jstate, m)))
        out["curve"].append(float(m["loss"]))
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("rwkv_chunk,ssm_seq_chunk", SETTINGS)
def test_forward_train_loss_and_gradients(setup, rwkv_chunk, ssm_seq_chunk):
    """Loss within 1e-5 relative; every gradient leaf within 1e-4 of that
    leaf's max |g| (llama's rule: fp32 sums in other orders)."""
    _, cfg, jp, batch = setup
    _, to = _opts(rwkv_chunk, ssm_seq_chunk)
    ref = _jax_run(rwkv_chunk, ssm_seq_chunk)
    wl, wg = ref["loss"], ref["grads"]
    loss, g = value_and_grad(lambda p: forward_train(cfg, to, p, _torch_batch(batch))[0],
                             lm_from_jax(jp))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    for a, b in zip(tree_leaves(lm_from_jax(wg)), tree_leaves(g)):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


def test_chunk_options_that_do_not_divide_the_sequence_change_nothing(setup):
    """Neither lever applies where its chunk does not divide S (or is not
    below it, for ssm_seq_chunk): the loss and gradients are bit for bit
    those of (0, 0), as the reference's conditions say."""
    _, cfg, jp, batch = setup
    out = []
    for opts in (_opts(0, 0)[1], _opts(7, 0)[1], _opts(0, 7)[1], _opts(0, SEQ)[1]):
        out.append(value_and_grad(
            lambda p, o=opts: forward_train(cfg, o, p, _torch_batch(batch))[0],
            lm_from_jax(jp)))
    (l0, g0), *rest = out
    for loss, g in rest:
        assert torch.equal(loss, l0)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(g0)))


@pytest.mark.parametrize("rwkv_chunk,ssm_seq_chunk", SETTINGS)
def test_train_step(setup, rwkv_chunk, ssm_seq_chunk):
    """One step from the same params, state and batch: loss 1e-5 relative,
    grad norm 1e-4 relative; params and moments within 1e-5 wherever |g| >
    1e-6 and |g| > 1e-3 of its leaf's max |g|. ROADMAP C4: the first step
    moves a param by lr·g / (|g| + eps), so an element whose |g| is near
    eps moves with the gradient's fp32 noise, which is up to ~1e-5 of its
    leaf's max |g| (rwkv6's embed gradient spans 0.27 down to 3e-6, where
    that noise is some 10% of g; llama's test needs only the first bound)."""
    _, cfg, jp, batch = setup
    _, to = _opts(rwkv_chunk, ssm_seq_chunk)
    ref = _jax_run(rwkv_chunk, ssm_seq_chunk)
    wg, (wp, ws, wm) = ref["grads"], ref["step1"]

    params = lm_from_jax(jp)
    state = lm_adamw_from_jax(jax.tree.map(np.asarray, jax_adamw_init(jp)))
    p, st, m = make_train_step(cfg, to, lr=LR)(params, state, _torch_batch(batch))
    assert p is params and st is state  # updated in place
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]), rtol=1e-4)
    assert int(st["step"]) == int(ws["step"]) == 1
    big = [(np.abs(a) > 1e-6) & (np.abs(a) > 1e-3 * np.abs(a).max())
           for a in map(np.asarray, jax.tree.leaves(wg))]
    got = {"params": lm_to_jax(p), **lm_adamw_to_jax(st)}
    for name, want in (("params", wp), ("m", ws["m"]), ("v", ws["v"])):
        for a, b, keep in zip(jax.tree.leaves(want), jax.tree.leaves(got[name]), big):
            a = np.asarray(a)
            assert a.shape == b.shape
            np.testing.assert_allclose(b[keep], a[keep], rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rwkv_chunk,ssm_seq_chunk", SETTINGS)
def test_loss_curve_over_five_steps_matches_the_reference(setup, rwkv_chunk, ssm_seq_chunk):
    """Five ``make_train_step`` steps at ``train_lm``'s lr (1e-3) in each
    package from the same params and AdamW state on the same
    ``token_batches`` stream: loss 1e-5 relative at step 1 and 1e-4 after
    (C4: AdamW carries the gradients' fp32 noise forward), rising and
    falling at the same steps."""
    _, cfg, jp, _ = setup
    _, to = _opts(rwkv_chunk, ssm_seq_chunk)
    want = _jax_run(rwkv_chunk, ssm_seq_chunk)["curve"]
    params = lm_from_jax(jp)
    state = lm_adamw_from_jax(jax.tree.map(np.asarray, jax_adamw_init(jp)))
    step = make_train_step(cfg, to, lr=LR)
    tb = token_batches(np.random.default_rng(0), cfg.vocab_size, B, SEQ)
    got = [float(step(params, state, _torch_batch(next(tb)))[2]["loss"]) for _ in range(5)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
    assert np.array_equal(np.sign(np.diff(got)), np.sign(np.diff(want)))


def test_remat_changes_nothing(setup):
    """Checkpointed repeats and sequence chunks recompute the same ops, the
    scan's autograd function included: loss and gradients bit for bit."""
    _, cfg, jp, batch = setup
    from dataclasses import replace

    for _, to in (_opts(0, 0), _opts(0, 8)):
        out = [value_and_grad(lambda p, o=o: forward_train(cfg, o, p, _torch_batch(batch))[0],
                              lm_from_jax(jp))
               for o in (to, replace(to, remat=True))]
        (l0, g0), (l1, g1) = out
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def test_train_lm_on_cpu():
    res = train_lm(ARCH, steps=3, batch=2, seq=16, log_every=1, device="cpu")
    assert len(res.losses) == len(res.grad_norms) == len(res.step_s) == 3
    assert np.isfinite(res.losses).all() and res.tokens_per_step == 32


def test_train_lm_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm(ARCH, steps=1, batch=1, seq=8)
