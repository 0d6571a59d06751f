"""The port's serving loop against the JAX package's, and the LM converter.

A serve-style loop (decode-step prefill over the prompts, then greedy
generation with ``make_serve_step``) runs the reduced models on both sides
from the reference's parameters and the same prompts (and, for
whisper-small, the same random encoder states), drawn as
``repro.launch.serve`` draws them; the greedy tokens must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import ModelOpts as JaxOpts
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax, lm_to_jax
from repro_torch.launch.serve import fill_enc_out, main, serve
from repro_torch.launch.steps import default_opts, make_prefill_step, make_serve_step
from repro_torch.models.transformer import init_cache

ARCHS = ["llama3.2-3b", "rwkv6-1.6b", "gemma3-12b", "llama3-8b", "nemotron-4-15b",
         "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "zamba2-7b", "whisper-small",
         "llava-next-mistral-7b"]


def _prompts(vocab, B, prompt_len, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, (B, prompt_len)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_the_reference(arch):
    B, prompt_len, gen_len, cache_len, seed = 3, 5, 8, 16, 0
    jcfg = jax_reduced(jax_get_arch(arch))
    jo = JaxOpts(remat=False, attn_chunk=0)
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg, jo)
    cfg = reduced(get_arch(arch))
    opts = default_opts(cfg)
    p = lm_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, (B, prompt_len)).astype(np.int32)

    jstep = jax.jit(jax_make_serve_step(jcfg, jo))
    jc = jax_init_cache(jcfg, jo, B, cache_len, jnp.float32)
    step = make_serve_step(cfg, opts)
    c = init_cache(cfg, opts, B, cache_len, torch.float32, device="cpu")
    if cfg.enc_dec:
        # after the prompts, from the same generator, as the reference's serve
        state = rng.bit_generator.state
        jc["enc_out"] = jnp.asarray(rng.normal(0, 1, (B, cfg.enc_seq_len, cfg.d_model)),
                                    jnp.float32)
        rng.bit_generator.state = state
        fill_enc_out(cfg, c, rng)
        np.testing.assert_array_equal(c["enc_out"].numpy(), np.asarray(jc["enc_out"]))
    want, got = [], []
    for t in range(prompt_len + gen_len):
        if t < prompt_len:
            jtok = jnp.asarray(prompts[:, t:t + 1])
            tok = torch.from_numpy(prompts[:, t:t + 1]).long()
        jnxt, jlogits, jc = jstep(jp, jc, {"token": jtok, "pos": jnp.asarray(t)})
        nxt, logits, c = step(p, c, {"token": tok, "pos": t})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
        jtok, tok = jnxt[:, None], nxt[:, None].long()
        if t >= prompt_len - 1:
            want.append(np.asarray(jnxt))
            got.append(nxt.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    assert got[0].dtype == np.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu(arch):
    res = serve(arch, num_requests=3, prompt_len=4, gen_len=4, cache_len=16, device="cpu")
    cfg = reduced(get_arch(arch))
    assert res.tokens.shape == (3, 4)
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    assert res.logits_finite and res.prefill_s > 0 and res.gen_s > 0
    again = serve(arch, num_requests=3, prompt_len=4, gen_len=4, cache_len=16, device="cpu")
    np.testing.assert_array_equal(res.tokens, again.tokens)  # seeded: deterministic


def test_serve_cli_on_cpu(capsys):
    res = main(["--arch", "rwkv6-1.6b", "--requests", "2", "--prompt", "3", "--gen", "2",
                "--cache", "8", "--device", "cpu"])
    assert res.tokens.shape == (2, 2)
    assert "[serve] rwkv6-1.6b on cpu: 2 requests" in capsys.readouterr().out


def test_serve_rejects_a_short_cache():
    with pytest.raises(ValueError):
        serve("rwkv6-1.6b", prompt_len=8, gen_len=8, cache_len=12, device="cpu")


def test_prefill_step_is_forward_prefill():
    from repro_torch.models.transformer import ModelOpts, forward_prefill, init_params

    cfg = reduced(get_arch("llama3.2-3b"))
    opts = default_opts(cfg)
    assert opts == ModelOpts(kv_mult=1, attn_chunk=1024, remat=True)
    p = init_params(cfg, opts, seed=3, device="cpu")
    toks = torch.from_numpy(_prompts(cfg.vocab_size, 2, 6, 3)).long()
    assert torch.equal(make_prefill_step(cfg, opts)(p, {"tokens": toks}),
                       forward_prefill(cfg, opts, p, {"tokens": toks}))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_convert_round_trip_is_bit_exact(arch):
    from dataclasses import replace

    jcfg = replace(jax_reduced(jax_get_arch(arch)), param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(1), jcfg,
                                                  JaxOpts(remat=False)))
    p = lm_from_jax(jp)
    assert p["embed"].dtype == torch.bfloat16 and p["final_norm"]["scale"].dtype == torch.float32
    back = lm_to_jax(p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the values too, not only the bits: bf16 -> fp32 is exact on both sides
    np.testing.assert_array_equal(p["embed"].float().numpy(),
                                  np.asarray(jp["embed"], dtype=np.float32))
