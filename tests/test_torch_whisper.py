"""whisper-small's encoder-decoder form in the port against the JAX
package's, on the reduced config (two encoder layers over 32 frames, one
decoder layer with cross attention, learned position embeddings, fp32),
from the reference's parameters converted with ``lm_from_jax`` and the same
numpy inputs: cross attention (prefill and decode lengths, and a bf16
``enc_out`` under the fp32 model, where both packages project in fp32),
the encoder, the learned position embeddings' clamped start, prefill
logits with frames, eight decode steps against random encoder states
(logits and caches, ``enc_out`` included), decode reproducing prefill, and
the training loss with every gradient leaf, the encoder's included. fp32
sums in other orders: logits and activations within 1e-4, each gradient
leaf within 1e-4 of its max |g|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import attention as JA
from repro.models import forward_decode as jax_decode
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import transformer as JT
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.transformer import (
    ModelOpts,
    forward_decode,
    forward_prefill,
    forward_train,
    init_cache,
)
from repro_torch.tree import tree_leaves, value_and_grad

ARCH = "whisper-small"
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    """(jcfg, cfg, jax params, the port's converted params)."""
    jcfg = jax_reduced(jax_get_arch(ARCH))
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg, JaxOpts(remat=False))
    return jcfg, reduced(get_arch(ARCH)), jp, lm_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_the_reduced_config_has_an_encoder(model):
    jcfg, cfg, jp, p = model
    assert cfg.enc_dec and cfg.learned_pos_emb and cfg.enc_layers == 2
    assert cfg.enc_seq_len == 32 and cfg.frontend == "audio_stub"
    assert p["encoder"]["attn"]["wq"].shape[0] == cfg.enc_layers
    assert set(p["unit"]["blk0"]) >= {"ln_x", "xattn"} and "xattn" not in p["encoder"]


@pytest.mark.parametrize("train", [False, True], ids=["kernel_path", "train_path"])
@pytest.mark.parametrize("S", [1, 7])
def test_cross_attn_forward(model, S, train):
    """Decode (S = 1) and prefill lengths over 32 encoder frames; the
    kernel path (``ops.flash_attention(causal=False)``, its plain version
    here) and the training path (``mha``)."""
    jcfg, cfg, _, _ = model
    jp = jax.tree.map(np.asarray, JA.init_cross_attn(jax.random.PRNGKey(3), jcfg, jnp.float32))
    x, enc = _normal((2, S, cfg.d_model), S), _normal((2, cfg.enc_seq_len, cfg.d_model), 9)
    want = JA.cross_attn_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                 jnp.asarray(enc))
    got = A.cross_attn_forward(cfg, lm_from_jax(jp), torch.from_numpy(x),
                               torch.from_numpy(enc), train=train)
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.d_model)
    _close(got, want)


def test_cross_attn_bf16_enc_out_under_an_fp32_model(model):
    """A bf16 ``enc_out`` against fp32 weights: jnp promotes the products
    to fp32, and so does the port (``mm``), so nothing is rounded to bf16
    beyond the encoder states themselves."""
    jcfg, cfg, _, _ = model
    jp = jax.tree.map(np.asarray, JA.init_cross_attn(jax.random.PRNGKey(4), jcfg, jnp.float32))
    x = _normal((2, 3, cfg.d_model), 1)
    enc = jnp.asarray(_normal((2, cfg.enc_seq_len, cfg.d_model), 2)).astype(jnp.bfloat16)
    want = JA.cross_attn_forward(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x), enc)
    enc_t = torch.from_numpy(np.array(enc.astype(jnp.float32))).bfloat16()
    got = A.cross_attn_forward(cfg, lm_from_jax(jp), torch.from_numpy(x), enc_t)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("train", [False, True], ids=["kernel_path", "train_path"])
def test_encode(model, train):
    jcfg, cfg, jp, p = model
    frames = _normal((2, cfg.enc_seq_len, cfg.d_model), 5)
    want = JT._encode(jcfg, JaxOpts(remat=False), jp, jnp.asarray(frames))
    got = T._encode(cfg, ModelOpts(), p, torch.from_numpy(frames), train=train)
    assert got.shape == (2, cfg.enc_seq_len, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("offset", [0, 5, 250, 253, 1000])
def test_embed_tokens_clamps_the_position_start(model, offset):
    """Learned position rows from ``offset`` on; the reference's
    ``dynamic_slice_in_dim`` clamps the start to max_seq_len - S (256 - 6),
    so 253 and 1000 read the table's last six rows, as 250 does."""
    jcfg, cfg, jp, p = model
    toks = _tokens(cfg, 2, 6, seed=offset)
    want = JT._embed_tokens(jcfg, jp, jnp.asarray(toks), offset=offset)
    got = T._embed_tokens(cfg, p, torch.from_numpy(toks).long(), offset=offset)
    _close(got, want, 0.0)
    if offset >= cfg.max_seq_len - 6:
        last = T._embed_tokens(cfg, p, torch.from_numpy(toks).long(), offset=250)
        assert torch.equal(got, last)


def test_prefill_logits_with_frames(model):
    jcfg, cfg, jp, p = model
    toks, frames = _tokens(cfg, 2, 12, seed=0), _normal((2, cfg.enc_seq_len, cfg.d_model), 0)
    want = jax_prefill(jcfg, JaxOpts(remat=False), jp,
                       {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    got = forward_prefill(cfg, ModelOpts(), p, {"tokens": torch.from_numpy(toks).long(),
                                                "frames": torch.from_numpy(frames)})
    assert got.shape == want.shape
    _close(got, want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("positions", [range(8), range(250, 255), [300]],
                         ids=["from_0", "to_the_table_end", "past_max_seq_len"])
def test_decode_against_random_encoder_states(model, positions):
    """Decode steps at these positions against random encoder states in
    both packages (the zeros ``init_cache`` gives would hide cross
    attention): logits within 1e-4, then every cache leaf, ``enc_out``
    (left as it is) included. A position past max_seq_len - 1 reads the
    table's last row, and past the cache's end writes its last slot."""
    jcfg, cfg, jp, p = model
    jo, opts = JaxOpts(remat=False), ModelOpts()
    enc = _normal((2, cfg.enc_seq_len, cfg.d_model), 7)
    jc = jax_init_cache(jcfg, jo, 2, 12, jnp.float32)
    jc["enc_out"] = jnp.asarray(enc)
    c = init_cache(cfg, opts, 2, 12, torch.float32, device="cpu")
    c["enc_out"].copy_(torch.from_numpy(enc))
    toks = _tokens(cfg, 2, len(positions), seed=7)
    for i, pos in enumerate(positions):
        want, jc = jax_decode(jcfg, jo, jp, {"token": jnp.asarray(toks[:, i:i + 1]),
                                             "pos": jnp.asarray(pos)}, jc)
        got, c2 = forward_decode(cfg, opts, p, {"token": torch.from_numpy(toks[:, i:i + 1])
                                                .long(), "pos": pos}, c)
        assert c2 is c
        _close(got, want)
    got_leaves, want_leaves = _leaves(c), _leaves(jc)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        _close(g, w)
    assert torch.equal(c["enc_out"], torch.from_numpy(enc))


def test_decode_reproduces_prefill(model):
    """Token by token against the encoding of the prefill's frames."""
    _, cfg, _, p = model
    opts = ModelOpts()
    toks = torch.from_numpy(_tokens(cfg, 1, 8, seed=2)).long()
    frames = torch.from_numpy(_normal((1, cfg.enc_seq_len, cfg.d_model), 2))
    full = forward_prefill(cfg, opts, p, {"tokens": toks, "frames": frames})
    c = init_cache(cfg, opts, 1, 9, torch.float32, device="cpu")
    c["enc_out"].copy_(T._encode(cfg, opts, p, frames))
    for t in range(8):
        logits, c = forward_decode(cfg, opts, p, {"token": toks[:, t:t + 1], "pos": t}, c)
    torch.testing.assert_close(logits, full, rtol=0, atol=TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_training_loss_and_every_gradient_leaf(model, remat):
    """forward_train with frames: the loss within 1e-5 relative, every
    gradient leaf (the encoder's, the cross attention's and the position
    tables' included) within 1e-4 of its max |g| against ``jax.grad``; with
    ``remat`` the repeats are recomputed in the backward pass."""
    jcfg, cfg, jp, p = model
    toks = _tokens(cfg, 2, 16, seed=3)
    labels = _tokens(cfg, 2, 16, seed=4)
    frames = _normal((2, cfg.enc_seq_len, cfg.d_model), 3)
    jo = JaxOpts(remat=remat, attn_chunk=0)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "frames": jnp.asarray(frames)}
    wl, wg = jax.value_and_grad(lambda prm: jax_forward_train(jcfg, jo, prm, jb)[0])(jp)
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long(),
          "frames": torch.from_numpy(frames)}
    loss, g = value_and_grad(
        lambda prm: forward_train(cfg, ModelOpts(remat=remat), prm, tb)[0], p)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    want = tree_leaves(lm_from_jax(jax.tree.map(np.asarray, wg)))
    got = tree_leaves(g)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
    assert float(g["encoder"]["attn"]["wq"].abs().max()) > 0
    assert float(g["enc_pos"].abs().max()) > 0 and float(g["pos_embed"].abs().max()) > 0
