"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on reduced qwen2-moe-a2.7b (4 experts, top
2, a shared MLP), from the reference's parameters converted with
``lm_from_jax`` and the same numpy inputs: y and the aux losses within
1e-5, with and without dropped tokens; the gradients; experts padded to a
multiple of 8, which no token may reach; ties in the routing."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import moe as JM
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.models import moe as M

TOL = 1e-5
ARCH = "qwen2-moe-a2.7b"
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(pad_to=1, seed=0, **change):
    jcfg = replace(jax_reduced(jax_get_arch(ARCH)), **change)
    cfg = replace(reduced(get_arch(ARCH)), **change)
    jp = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32,
                                              pad_to))
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, x


def _routing(cfg, p, x):
    """(experts per token slot, capacity, tokens each expert is sent) as the
    port routes x."""
    T = x.shape[0] * x.shape[1]
    logits = torch.from_numpy(x).reshape(T, -1) @ p["router"]
    e_pad = logits.shape[-1]
    logits[:, cfg.num_experts:] = -1e30
    _, top_e = M._top_k(torch.softmax(logits, -1), cfg.moe_top_k)
    return top_e, torch.bincount(top_e.reshape(-1), minlength=e_pad)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


# capacity factor: 4.0 leaves every expert room for every token (no drop);
# None is the config's 1.25; 0.25 gives the minimum capacity of 8 slots,
# fewer than the busiest expert's tokens, so some are dropped
@pytest.mark.parametrize("cf,drops", [(4.0, False), (None, None), (0.25, True)])
def test_moe_forward_matches_the_reference(cf, drops):
    jcfg, cfg, jp, x = _setup()
    p = lm_from_jax(jp)
    want, waux = JM.moe_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                capacity_factor=cf)
    got, aux = M.moe_forward(cfg, p, torch.from_numpy(x), capacity_factor=cf)
    T, k = B * S, cfg.moe_top_k
    cap = max(8, int(T * k * (cf or cfg.capacity_factor) / cfg.num_experts))
    _, counts = _routing(cfg, p, x)
    if drops is not None:
        assert bool((counts > cap).any()) == drops, (counts, cap)
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)
    for name in ("lb_loss", "router_z"):
        assert aux[name].dtype == torch.float32 and aux[name].shape == ()
        _close(aux[name], waux[name])


def test_dropped_tokens_keep_only_the_shared_mlp_and_their_other_slots():
    """At capacity 8 a token past an expert's eighth slot (token-major,
    then slot order) gets nothing from that expert: with the shared MLP
    and the other experts' weights zeroed, its y is exactly 0, and the
    reference drops the same tokens."""
    jcfg, cfg, jp, x = _setup(seed=1)
    jp = dict(jp)
    jp["shared"] = {k: np.zeros_like(v) for k, v in jp["shared"].items()}
    p = lm_from_jax(jp)
    top_e, counts = _routing(cfg, p, x)
    busiest = int(counts.argmax())
    assert counts[busiest] > 8
    for key in ("up", "gate", "down"):
        keep = np.zeros_like(jp[key])
        keep[busiest] = jp[key][busiest]
        jp[key] = keep
    p = lm_from_jax(jp)
    got, _ = M.moe_forward(cfg, p, torch.from_numpy(x), capacity_factor=0.25)
    want, _ = JM.moe_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             capacity_factor=0.25)
    _close(got, want)
    sent = (top_e == busiest).any(-1).nonzero()[:, 0]  # tokens in token order
    rows = got.reshape(B * S, -1)
    assert (rows[sent[:8]].abs().sum(-1) > 0).all()
    assert (rows[sent[8:]] == 0).all()


def test_moe_gradients_match_the_reference():
    """The gradient of sum(y * c) + lb_loss + router_z with respect to every
    parameter (the router's through the top-k weights, the load-balance
    mean and the z-loss) and to x, each within 1e-5 of its max |g|, with
    tokens dropped."""
    jcfg, cfg, jp, x = _setup(seed=2)
    c = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(prm, xx):
        y, aux = JM.moe_forward(jcfg, prm, xx, capacity_factor=0.5)
        return jnp.sum(y * c) + aux["lb_loss"] + aux["router_z"]

    wg, wgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    p = {k: v.requires_grad_(True) if torch.is_tensor(v) else
         {kk: vv.requires_grad_(True) for kk, vv in v.items()}
         for k, v in lm_from_jax(jp).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.moe_forward(cfg, p, xt, capacity_factor=0.5)
    (torch.sum(y * torch.from_numpy(c)) + aux["lb_loss"] + aux["router_z"]).backward()
    pairs = [(p[k].grad, wg[k]) for k in ("router", "up", "gate", "down")]
    pairs += [(p["shared"][k].grad, wg["shared"][k]) for k in p["shared"]]
    pairs += [(xt.grad, wgx)]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        _close(got, want, TOL * np.abs(want).max())


def test_padded_experts_receive_no_token():
    """expert_pad_to 8 over 4 real experts: the router and the stacks have
    8 experts, the padded ones get -1e30 logits, so y and the aux losses
    are those of the 4 real experts alone (and the reference's), and no
    gradient reaches a padded expert's weights."""
    jcfg, cfg, jp, x = _setup(pad_to=8, seed=4)
    assert jp["router"].shape == (cfg.d_model, 8) and jp["up"].shape[0] == 8
    p = {k: v.requires_grad_(True) if torch.is_tensor(v) else v
         for k, v in lm_from_jax(jp).items()}
    want, waux = JM.moe_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    got, aux = M.moe_forward(cfg, p, torch.from_numpy(x))
    _close(got, want)
    _close(aux["lb_loss"], waux["lb_loss"])
    _close(aux["router_z"], waux["router_z"])
    top_e, counts = _routing(cfg, p, x)
    assert (top_e < cfg.num_experts).all() and (counts[cfg.num_experts:] == 0).all()
    real = {k: (v[:, :4] if k == "router" else v[:4]) if torch.is_tensor(v) else v
            for k, v in p.items()}
    alone, alone_aux = M.moe_forward(cfg, real, torch.from_numpy(x))
    torch.testing.assert_close(got, alone, rtol=0, atol=1e-6)
    torch.testing.assert_close(aux["lb_loss"], alone_aux["lb_loss"], rtol=0, atol=1e-6)
    (got.sum() + aux["lb_loss"] + aux["router_z"]).backward()
    for key in ("up", "gate", "down"):
        assert (p[key].grad[4:] == 0).all() and p[key].grad[:4].abs().max() > 0
    assert (p["router"].grad[:, 4:] == 0).all()


def test_init_moe_has_the_reference_layout():
    jcfg, cfg, jp, _ = _setup(pad_to=8)
    mine = M.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, 8)
    shapes = {k: (tuple(v.shape) if torch.is_tensor(v) else
                  {kk: tuple(vv.shape) for kk, vv in v.items()}) for k, v in mine.items()}
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jp)
    assert mine["router"].dtype == torch.float32
    assert M.pad_experts(60, 8) == JM.pad_experts(60, 8) == 64


def test_top_k_breaks_ties_by_the_lower_index_as_jax():
    """Tied probabilities: the lower expert index first, as jax.lax.top_k."""
    probs = np.array([[0.2, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.4, 0.1]], np.float32)
    jw, je = jax.lax.top_k(jnp.asarray(probs), 3)
    w, e = M._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("act", ["gelu_glu", "sq_relu"])
def test_other_expert_activations_match_the_reference(act):
    """The expert MLP's other activations (qwen2-moe's is silu_glu): the
    tanh GELU of jax.nn.gelu's default, and squared ReLU without a gate."""
    jcfg, cfg, jp, x = _setup(seed=5, mlp_act=act)
    want, _ = JM.moe_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    got, _ = M.moe_forward(cfg, lm_from_jax(jp), torch.from_numpy(x))
    assert ("gate" in jp) == (act == "gelu_glu")
    _close(got, want)


def test_model_opts_pad_the_experts_as_the_reference():
    """``ModelOpts.expert_pad_to`` reaches every MoE block through
    ``init_params``, with the reference's layout; the reference's padded
    model, converted, gives its prefill logits within 1e-4."""
    from repro.models import ModelOpts as JaxOpts
    from repro.models import forward_prefill as jax_prefill
    from repro.models import init_params as jax_init_params
    from repro_torch.models.transformer import ModelOpts, forward_prefill, init_params
    from repro_torch.tree import tree_map

    jcfg, cfg = jax_reduced(jax_get_arch(ARCH)), reduced(get_arch(ARCH))
    jo = JaxOpts(remat=False, expert_pad_to=8)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg, jo)
    mine = init_params(cfg, ModelOpts(expert_pad_to=8), seed=0, device="cpu")
    assert tree_map(lambda t: tuple(t.shape), mine) == jax.tree.map(lambda a: tuple(a.shape), jp)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = jax_prefill(jcfg, jo, jp, {"tokens": jnp.asarray(toks)})
    got = forward_prefill(cfg, ModelOpts(remat=False, expert_pad_to=8),
                          lm_from_jax(jax.tree.map(np.asarray, jp)),
                          {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
