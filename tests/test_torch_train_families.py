"""The port's LM training path against the JAX package's on the block kinds
beyond ``attn`` and ``rwkv6``: reduced gemma3-12b (five ``local_attn``
layers with a 32-token window, one global layer, QK-norm) and reduced
qwen2-moe-a2.7b (``moe`` blocks, whose router losses join the loss), in
fp32, from the reference's parameters converted with ``lm_from_jax`` and
one ``token_batches`` batch of 2 x 48 tokens (past the window). The loss
and its terms within 1e-5 relative and every gradient leaf within 1e-4 of
that leaf's max |g|, with ``remat`` off and on (the router losses summed
once through the checkpointed repeats); one ``make_train_step``; and
``train_lm`` on each reduced family on the CPU, zamba2-7b's included."""
from dataclasses import replace

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
from repro_torch.convert import lm_adamw_from_jax, lm_from_jax
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train_lm
from repro_torch.models.transformer import ModelOpts, forward_train
from repro_torch.tree import tree_leaves, value_and_grad

B, S = 2, 48
# qwen2-moe at capacity factor 0.5: 24 slots an expert for the batch's 192
# routed slots over 4 experts, so the busiest experts drop tokens
CHANGES = {"gemma3-12b": {}, "qwen2-moe-a2.7b": {"capacity_factor": 0.5}}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CHANGES))
def setup(request):
    arch = request.param
    jcfg = replace(jax_reduced(jax_get_arch(arch)), **CHANGES[arch])
    cfg = replace(reduced(get_arch(arch)), **CHANGES[arch])
    jp = jax.tree.map(np.asarray,
                      jax_init_params(jax.random.PRNGKey(0), jcfg, JaxOpts(remat=False)))
    batch = next(jax_token_batches(np.random.default_rng(0), jcfg.vocab_size, B, S))
    return jcfg, cfg, jp, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_aux_and_gradients_match_the_reference(setup, remat):
    jcfg, cfg, jp, batch = setup
    jo, to = JaxOpts(remat=remat, attn_chunk=0), ModelOpts(remat=remat, attn_chunk=0)
    jb = _jax_batch(batch)
    (wl, waux), wg = jax.value_and_grad(lambda p: jax_forward_train(jcfg, jo, p, jb),
                                        has_aux=True)(jax.tree.map(jnp.asarray, jp))
    aux = {}

    def loss_fn(p):
        loss, a = forward_train(cfg, to, p, _torch_batch(batch))
        aux.update(a)
        return loss

    loss, g = value_and_grad(loss_fn, lm_from_jax(jp))
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    aux = {k: float(v.detach()) for k, v in aux.items()}
    for k in ("ce", "lb_loss", "router_z"):
        np.testing.assert_allclose(aux[k], float(waux[k]), rtol=1e-5)
    moe = any(b.kind == "moe" for b in cfg.blocks)
    assert (aux["lb_loss"] > 0) == moe and (aux["router_z"] > 0) == moe
    want = tree_leaves(lm_from_jax(jax.tree.map(np.asarray, wg)))
    got = tree_leaves(g)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
    if moe:
        router = g["unit"]["blk0"]["moe"]["router"]
        assert router.abs().max() > 0  # the router's gradient reaches it


def test_train_step_matches_the_reference(setup):
    """One make_train_step: loss and lb_loss 1e-5 relative, grad norm 1e-4
    relative."""
    jcfg, cfg, jp, batch = setup
    jo, to = JaxOpts(remat=True, attn_chunk=0), ModelOpts(remat=True, attn_chunk=0)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jax_adamw_init(jparams)
    _, _, wm = jax_make_train_step(jcfg, jo, lr=1e-2)(jparams, jstate, _jax_batch(batch))
    p = lm_from_jax(jp)
    state = lm_adamw_from_jax(jax.tree.map(np.asarray, jstate))
    _, _, m = make_train_step(cfg, to, lr=1e-2)(p, state, _torch_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["lb_loss"]), float(wm["lb_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]), rtol=1e-4)
    assert not m["lb_loss"].requires_grad


@pytest.mark.parametrize("arch", ["gemma3-12b", "llama3-8b", "nemotron-4-15b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "zamba2-7b"])
def test_train_lm_on_cpu(arch):
    res = train_lm(arch, steps=2, batch=2, seq=16, log_every=1, device="cpu")
    assert len(res.losses) == 2 and np.isfinite(res.losses + res.grad_norms).all()
