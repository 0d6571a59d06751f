"""llava-next-mistral-7b's media prefix in the port against the JAX
package's, on the reduced config (16 media rows, fp32): prefill with the
media rows in front of the tokens (positions over media + text), the
training loss on the text positions alone with every gradient leaf, and
``input_specs``' media/text split of a sequence, from the reference's
parameters converted with ``lm_from_jax`` and the same numpy inputs. fp32
sums in other orders: logits within 1e-4, the loss within 1e-5 relative,
each gradient leaf within 1e-4 of its max |g|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import InputShape
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.launch.steps import input_specs as jax_input_specs
from repro.models import ModelOpts as JaxOpts
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.launch.steps import input_specs
from repro_torch.launch.train import stub_inputs
from repro_torch.models.transformer import ModelOpts, forward_prefill, forward_train
from repro_torch.tree import tree_leaves, value_and_grad

ARCH = "llava-next-mistral-7b"


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_arch(ARCH))
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg, JaxOpts(remat=False))
    return jcfg, reduced(get_arch(ARCH)), jp, lm_from_jax(jax.tree.map(np.asarray, jp))


def _inputs(cfg, B, M, S, seed):
    rng = np.random.default_rng(seed)
    media = rng.standard_normal((B, M, cfg.d_model)).astype(np.float32)
    return media, rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("M", [0, 5, 16])
def test_prefill_with_media(model, M):
    """M media rows in front of 9 tokens (0: a text prompt); the media rows
    move the text's positions, so the logits differ from a text-only
    prompt's."""
    jcfg, cfg, jp, p = model
    media, toks = _inputs(cfg, 2, M, 9, seed=M)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    if M:
        jb["media"], tb["media"] = jnp.asarray(media), torch.from_numpy(media)
    want = jax_prefill(jcfg, JaxOpts(remat=False), jp, jb)
    got = forward_prefill(cfg, ModelOpts(), p, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    if M:
        text = forward_prefill(cfg, ModelOpts(), p, {"tokens": tb["tokens"]})
        assert (text - got).abs().max() > 1e-3


@pytest.mark.parametrize("remat", [False, True])
def test_training_on_the_text_positions(model, remat):
    """Labels cover the 12 text tokens only (the 16 media rows carry
    none): the loss and every gradient leaf against ``jax.grad``."""
    jcfg, cfg, jp, p = model
    media, toks = _inputs(cfg, 2, 16, 12, seed=3)
    labels = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "media": jnp.asarray(media)}
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long(),
          "media": torch.from_numpy(media)}
    jo = JaxOpts(remat=remat, attn_chunk=0)
    wl, wg = jax.value_and_grad(lambda prm: jax_forward_train(jcfg, jo, prm, jb)[0])(jp)
    loss, g = value_and_grad(
        lambda prm: forward_train(cfg, ModelOpts(remat=remat), prm, tb)[0], p)
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
    want, got = tree_leaves(lm_from_jax(jax.tree.map(np.asarray, wg))), tree_leaves(g)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


@pytest.mark.parametrize("arch", [ARCH, "whisper-small", "llama3-8b"])
@pytest.mark.parametrize("seq", [4096, 7, 5000, 6000])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_input_specs_match_the_reference(arch, seq, mode):
    """The media/text split (media = min(num_media_tokens, seq // 2): 2048
    + 2048 at 4096, all 2880 media rows at 6000, 3 + 4 at 7), frames, and
    the decode batch, shape for shape and dtype for dtype, on the meta
    device."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    want = jax_input_specs(jcfg, InputShape("x", seq, 3, mode), JaxOpts())
    got = input_specs(cfg, 3, seq, mode)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype)[6:] == str(want[k].dtype)
        assert got[k].device.type == "meta"
    if arch == ARCH and mode != "decode":
        media = min(cfg.num_media_tokens, seq // 2)
        assert got["media"].shape[1] == media and got["tokens"].shape[1] == seq - media


def test_input_specs_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        input_specs(get_arch(ARCH), 1, 8, "serve")


def test_train_lm_feeds_the_reference_stubs():
    """Zeros in the compute dtype: min(num_media_tokens, 16) media rows, or
    enc_seq_len frames; nothing for a text model."""
    for arch, key, rows in ((ARCH, "media", 16), ("whisper-small", "frames", 1500)):
        cfg = get_arch(arch)
        (k, t), = stub_inputs(cfg, 2, "cpu").items()
        assert k == key and t.shape == (2, rows, cfg.d_model) and t.dtype == torch.bfloat16
        assert not t.any()
    assert stub_inputs(get_arch("llama3-8b"), 2, "cpu") == {}
