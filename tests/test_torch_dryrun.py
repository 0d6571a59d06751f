"""The port's dry run against the JAX package's: every (architecture, input
shape) pair's status and skip reason, the long-variant switch, the
production meshes' device counts; one-card traces on ``meta`` for each
architecture and each mode; on reduced configs the trace's FLOPs and
output shapes against a real CPU run of the same step; and each kernel
wrapper's meta entry against its plain version."""
import dataclasses
from unittest import mock

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.configs import with_long_variant as jax_with_long_variant
from repro.launch.dryrun import shape_skip_reason as jax_skip
from repro_torch.configs import INPUT_SHAPES, get_arch, reduced, with_long_variant
from repro_torch.kernels import _lib
from repro_torch.kernels import ref as R
from repro_torch.kernels.distill_loss import loss_flops
from repro_torch.kernels.flash_attention import attention_flops, latent_decode_flops
from repro_torch.kernels.rwkv6_scan import scan_flops, scan_grad_flops
from repro_torch.launch import dryrun as D
from repro_torch.launch.steps import default_opts
from repro_torch.tree import tree_leaves

ARCHS = sorted(jax_list_archs())


def test_every_pair_is_skipped_or_kept_as_the_reference():
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            for long_variant in (False, True):
                want = jax_skip(jax_get_arch(arch), shape, long_variant)
                assert D.shape_skip_reason(get_arch(arch), shape, long_variant) == want
                if long_variant and shape != "long_500k":
                    continue  # the switch reads long_500k alone
                # a production record's head (its trace is
                # test_torch_dtensor_trace.py's): skipped pairs are whole records
                rec, cfg = D.record_head(arch, shape, long_variant=long_variant)
                assert rec.get("status") == ("skipped" if want else None), (arch, shape)
                assert (cfg is None) == bool(want)
                assert rec.get("reason") == want
                if want:
                    assert D.run_one(arch, shape, long_variant=long_variant,
                                     out_dir=None) == rec
                variant = (long_variant and want is None and shape == "long_500k"
                           and get_arch(arch).long_context == "window")
                assert rec.get("arch_variant") == (
                    jax_with_long_variant(jax_get_arch(arch)).name if variant else None)


def test_long_variant_is_the_references():
    for arch in ARCHS:
        want = dataclasses.asdict(jax_with_long_variant(jax_get_arch(arch)))
        assert dataclasses.asdict(with_long_variant(get_arch(arch))) == want


def test_production_meshes_records(tmp_path):
    """Both production meshes' records traced in one child process each
    (``run_records``): per-device temporaries, peak and collectives where
    the spec rules alone left ``None``, written under the reference's file
    names; a skipped pair traces nothing."""
    jobs = [dict(arch="whisper-small", shape_name="prefill_32k", out_dir=str(tmp_path)),
            dict(arch="rwkv6-1.6b", shape_name="long_500k", multi_pod=True,
                 out_dir=str(tmp_path), tag="t")]
    for rec, devices, mesh in zip(D.run_records(jobs), (256, 512), ("16x16", "2x16x16")):
        assert rec["status"] == "ok" and rec["num_devices"] == devices and rec["mesh"] == mesh
        m = rec["memory"]
        assert isinstance(m["temp_bytes"], int) and m["temp_bytes"] > 0
        assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
        assert rec["collectives"] and rec["collectives_counted"] == "whole_step"
        assert "not_traced" not in rec
    assert (tmp_path / "whisper-small__prefill_32k__16x16.json").exists()
    assert (tmp_path / "rwkv6-1.6b__long_500k__2x16x16__t.json").exists()
    rec = D.run_one("whisper-small", "long_500k", out_dir=None)
    assert rec["status"] == "skipped"


# each architecture traced on one card at least once, each mode at least
# once; the other pairs are traced by chip_smoke.py's dry run
ONE_CARD = [(arch, "decode_32k") for arch in ARCHS] + [
    ("rwkv6-1.6b", "train_4k"), ("whisper-small", "train_4k"),
    ("llama3.2-3b", "prefill_32k"), ("whisper-small", "prefill_32k"),
    ("deepseek-v2-lite-16b", "prefill_32k"), ("qwen2-moe-a2.7b", "prefill_32k"),
    ("rwkv6-1.6b", "long_500k"), ("deepseek-v2-lite-16b", "long_500k")]
FITS = {("whisper-small", "prefill_32k"), ("rwkv6-1.6b", "decode_32k"),
        ("rwkv6-1.6b", "long_500k"), ("deepseek-v2-lite-16b", "long_500k")}


@pytest.mark.parametrize("arch,shape", ONE_CARD)
def test_one_card_trace(arch, shape):
    rec = D.run_one(arch, shape, card=True, out_dir=None)
    m, s = rec["memory"], INPUT_SHAPES[shape]
    assert rec["status"] == "ok" and rec["mesh"] == "1x1" and rec["num_devices"] == 1
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"] and m["temp_bytes"] >= 0
    assert rec["fits_one_card"] == ((arch, shape) in FITS)
    assert rec["fits_one_card"] == (m["peak_bytes"] <= rec["card_bytes"] - D.HEADROOM)
    cfg = get_arch(arch)
    step, args = D.step_inputs(cfg, default_opts(cfg), s.mode, s.global_batch, s.seq_len)
    tensors = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    assert m["argument_bytes"] == sum(-(-t.untyped_storage().nbytes() // 512) * 512
                                      for t in {id(t.untyped_storage()): t
                                                for t in tensors}.values())
    assert rec["cost"]["flops"] == rec["cost"]["flops_torch"] + rec["cost"]["flops_kernels"] > 0
    vocab = ((cfg.vocab_size + 127) // 128) * 128
    if s.mode == "decode":
        assert rec["outputs"]["logits"][0] == [s.global_batch, vocab]
        assert rec["outputs"]["next_token"] == ([s.global_batch], "int32")
        kernels = rec["cost"]["kernels"]
        want = ({"flash_attention_latent_decode"} if arch == "deepseek-v2-lite-16b"
                else {"rwkv6_scan"} if arch == "rwkv6-1.6b" else {"flash_attention_decode"})
        assert want <= set(kernels)
    elif s.mode == "prefill":
        assert rec["outputs"]["logits"][0] == [s.global_batch, vocab]
    else:
        assert set(rec["outputs"]) == {"loss", "ce", "grad_norm", "lb_loss"}


def _reduced(arch):
    return reduced(get_arch(arch))


def _declared(flops: list):
    """Patches of the plain versions the wrappers run on the CPU: each call
    adds the FLOPs its kernel declares to ``flops`` and runs with the
    FlopCounterMode paused, so that a CPU run counts what a meta trace
    counts (the torch ops by the counter, each kernel by its declaration)."""

    def wrap(fn, count):
        def patched(*a, **kw):
            flops.append(count(*a, **kw))
            with _disable_current_modes():
                return fn(*a, **kw)
        return patched

    def attn(q, k, v, *, causal=True, window=0, q_offset=0):
        B, Sq, N, H = q.shape
        return attention_flops(B, Sq, k.shape[1], N, H, v.shape[3], causal, window, q_offset)

    def scan(r, *a, **kw):
        return scan_flops(*r.shape)

    def scan_grad(r, *a, **kw):
        return scan_grad_flops(*r.shape)

    def xent(z, y, lw=1.0, **kw):
        return loss_flops("fwd", False, z.shape[0] * z.shape[1], z.shape[2])

    def xent_grad(z, y, lw=1.0, **kw):
        return loss_flops("bwd", False, z.shape[0] * z.shape[1], z.shape[2])

    def latent(q, c_kv, k_rope, *, scale, q_offset):
        return latent_decode_flops(q.shape[0], q.shape[2], c_kv.shape[1], c_kv.shape[2],
                                   k_rope.shape[2], q_offset)

    return [mock.patch.object(R, name, wrap(getattr(R, name), count)) for name, count in (
        ("flash_attention_ref", attn), ("rwkv6_scan_ref", scan),
        ("rwkv6_scan_grad_ref", scan_grad), ("softmax_xent_ref", xent),
        ("softmax_xent_grad_ref", xent_grad), ("latent_decode_ref", latent))]


@pytest.mark.parametrize("arch,mode,opts", [
    ("llama3.2-3b", "train", {"use_kernels": True}), ("llama3.2-3b", "prefill", {}),
    ("llama3.2-3b", "decode", {}), ("rwkv6-1.6b", "train", {"use_kernels": True}),
    ("rwkv6-1.6b", "prefill", {}), ("deepseek-v2-lite-16b", "decode", {}),
    ("whisper-small", "train", {"use_kernels": True}), ("qwen2-moe-a2.7b", "prefill", {})])
def test_meta_trace_counts_what_a_cpu_run_computes(arch, mode, opts):
    """FLOPs and output shapes of the meta trace equal a real CPU run of the
    same step on a reduced config (deepseek-v2-lite-16b at its full MLA
    dims, which the latent decode kernel takes)."""
    cfg = _reduced(arch)
    if arch == "deepseek-v2-lite-16b":
        full = get_arch(arch)
        cfg = dataclasses.replace(cfg, kv_lora_rank=full.kv_lora_rank,
                                  qk_rope_dim=full.qk_rope_dim, qk_nope_dim=full.qk_nope_dim,
                                  v_head_dim=full.v_head_dim)
    o = default_opts(cfg, **opts)
    batch, seq = 2, 64
    rec = D.one_card(cfg, mode, batch, seq, opts=o)

    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.optim import adamw_init

    _, meta_args = D.step_inputs(cfg, o, mode, batch, seq)
    g = torch.Generator().manual_seed(0)
    b = {k: (torch.randint(0, cfg.vocab_size, v.shape, dtype=v.dtype, generator=g)
             if v.dtype == torch.int32 else torch.randn(v.shape, generator=g).to(v.dtype))
         if isinstance(v, torch.Tensor) else v for k, v in meta_args[-1].items()}
    params = init_params(cfg, o, seed=0, device="cpu")
    if mode == "train":
        step, args = make_train_step(cfg, o), (params, adamw_init(params), b)
    elif mode == "prefill":
        step, args = make_prefill_step(cfg, o), (params, b)
    else:
        cache = init_cache(cfg, o, batch, seq, torch.float32, device="cpu")
        step, args = make_serve_step(cfg, o), (params, cache, b)
    declared: list = []
    counter = FlopCounterMode(display=False)
    patches = _declared(declared)
    for p in patches:
        p.start()
    try:
        with counter:
            out = step(*args)
    finally:
        for p in patches:
            p.stop()
    assert declared, "no kernel's plain version ran"
    assert rec["cost"]["flops_kernels"] == sum(declared)
    assert rec["cost"]["flops_torch"] == counter.get_total_flops()
    assert rec["outputs"] == D.output_shapes(mode, out)


def _sink():
    heard = []
    return heard, _lib.meta_sink(lambda name, flops, scratch: heard.append((name, flops,
                                                                           scratch)))


def _meta(*ts):
    return [t.to("meta") for t in ts]


def _same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.is_meta and tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype


def test_flash_attention_meta_entry():
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        latent_decode,
        sm90_launches,
        variant_launches,
    )

    g = torch.Generator().manual_seed(0)
    before = dict(_lib.launches), dict(variant_launches), dict(sm90_launches)
    for dtype, (B, Sq, Sk, N, K, H), qo, causal, window in [
            (torch.bfloat16, (1, 64, 64, 4, 2, 128), 0, True, 0),
            (torch.float32, (2, 33, 33, 4, 4, 64), 0, False, 0),
            (torch.float32, (8, 1, 4096, 4, 2, 128), 4095, True, 0),
            (torch.bfloat16, (2, 1, 300, 4, 2, 64), 299, True, 64)]:
        q = torch.randn(B, Sq, N, H, generator=g).to(dtype)
        k, v = (torch.randn(B, Sk, K, H, generator=g).to(dtype) for _ in range(2))
        want = flash_attention(q, k, v, causal=causal, window=window, q_offset=qo)
        heard, sink = _sink()
        with sink:
            got = flash_attention(*_meta(q, k, v), causal=causal, window=window, q_offset=qo)
        _same([got], [want])
        (name, flops, scratch), = heard
        assert flops == attention_flops(B, Sq, Sk, N, H, H, causal, window, qo) > 0
        if Sq == 1:
            assert name == "flash_attention_decode"
            from repro_torch.kernels.flash_attention import _decode_plan

            splits = _decode_plan(B, K, Sk, qo, causal, window)[2]
            assert scratch == (B * N * splits * (H + 2) * 4 if splits > 1 else 0)
        else:
            assert name == ("flash_attention_sm90" if dtype == torch.bfloat16
                            else "flash_attention") and scratch == 0
    q = torch.randn(2, 1, 4, 576, generator=g)
    c, kr = torch.randn(2, 300, 512, generator=g), torch.randn(2, 300, 64, generator=g)
    want = latent_decode(q, c, kr, scale=0.1, q_offset=299)
    heard, sink = _sink()
    with sink:
        got = latent_decode(*_meta(q, c, kr), scale=0.1, q_offset=299)
    _same([got], [want])
    assert heard[0][:2] == ("flash_attention_latent_decode",
                            latent_decode_flops(2, 4, 300, 512, 64, 299))
    # a meta call launches and counts nothing
    assert (dict(_lib.launches), dict(variant_launches), dict(sm90_launches)) == before


def test_rwkv6_scan_meta_entry_forward_and_backward():
    from repro_torch.kernels.rwkv6_scan import CHUNK, rwkv6_scan, variant_launches

    g = torch.Generator().manual_seed(0)
    before = dict(_lib.launches), dict(variant_launches)
    for T in (1, 100):
        B, H, hd = 2, 2, 16
        r, k, v = (torch.randn(B, T, H, hd, generator=g) for _ in range(3))
        w = torch.rand(B, T, H, hd, generator=g)
        u, s0 = torch.randn(H, hd, generator=g), torch.randn(B, H, hd, hd, generator=g)
        ins = [t.requires_grad_(True) for t in (r, k, v, w, u, s0)]
        want = rwkv6_scan(*ins)
        gw = torch.autograd.grad(want[0].sum() + want[1].sum(), ins)
        mins = [t.detach().to("meta").requires_grad_(True) for t in ins]
        heard, sink = _sink()
        with sink:
            got = rwkv6_scan(*mins)
            gg = torch.autograd.grad(got[0].sum() + got[1].sum(), mins)
        _same(got, want)
        _same(gg, gw)
        names = [n for n, _, _ in heard]
        assert names == ["rwkv6_scan" if T <= 16 else "rwkv6_scan_chunked", "rwkv6_scan_bwd"]
        assert heard[0][1] == scan_flops(B, T, H, hd) and heard[1][1] == scan_grad_flops(
            B, T, H, hd)
        nc = -(-T // CHUNK)
        if T > 16:  # the chunked scan's per-chunk states, r', pending sums
            assert heard[0][2] == 4 * (B * H * nc * hd * hd + B * T * H * hd + B * H * nc * hd)
        assert heard[1][2] > 0  # the backward's chunk states and partial sums
    assert (dict(_lib.launches), dict(variant_launches)) == before


def test_distill_and_skr_meta_entries():
    from repro_torch.kernels import distill_loss as DL
    from repro_torch.kernels import skr_rectify as SK

    g = torch.Generator().manual_seed(0)
    before = dict(_lib.launches), dict(DL.variant_launches), dict(SK.variant_launches)
    z = torch.randn(2, 5, 300, generator=g, requires_grad=True)
    t = torch.log_softmax(torch.randn(2, 5, 300, generator=g), -1)
    y = torch.randint(0, 300, (2, 5), generator=g)
    for fn, args in ((DL.distill_loss_batched, (t, y, 1.5)), (DL.softmax_xent_batched, (y,))):
        want = fn(z, *args)
        (gz,) = torch.autograd.grad(want.sum(), [z])
        mz = z.detach().to("meta").requires_grad_(True)
        heard, sink = _sink()
        with sink:
            got = fn(mz, *[a.to("meta") if isinstance(a, torch.Tensor) else a for a in args])
            (gm,) = torch.autograd.grad(got.sum(), [mz])
        _same([got, gm], [want, gz])
        teacher = fn is DL.distill_loss_batched
        assert [f for _, f, _ in heard] == [loss_flops("fwd", teacher, 10, 300),
                                            loss_flops("bwd", teacher, 10, 300)]
    probs = torch.softmax(torch.randn(3, 6, 10, generator=g), -1)
    labels = torch.randint(0, 10, (3, 6), generator=g)
    q = torch.rand(3, 10, 4, generator=g)
    count = torch.randint(0, 5, (3, 10), generator=g, dtype=torch.int32)
    head = torch.randint(0, 4, (3, 10), generator=g, dtype=torch.int32)
    want = SK.skr_process_batched(probs, labels, q, count, head)
    heard, sink = _sink()
    with sink:
        got = SK.skr_process_batched(*_meta(probs, labels, q, count, head))
    _same(got, want)
    assert heard == [("skr_process", SK.process_flops(3, 6, 10, 4), 0)]
    qbar, counts = torch.rand(3, 10, generator=g), torch.randint(0, 3, (3, 10), generator=g)
    want = SK.skr_rectify_batched(probs, labels, qbar, counts)
    heard, sink = _sink()
    with sink:
        got = SK.skr_rectify_batched(*_meta(probs, labels, qbar, counts))
    _same([got], [want])
    assert heard == [("skr_rectify", SK.map_flops(18, 10), 0)]
    assert (dict(_lib.launches), dict(DL.variant_launches), dict(SK.variant_launches)) == before


def test_live_bytes_counts_storages_until_they_die():
    def step(a):
        b = torch.empty(1000, device="meta")  # 4,000 bytes: rounded to 4,096
        c = b.view(10, 100) * 2  # a view adds nothing, the product 4,096
        del b
        d = torch.empty(10, device="meta")  # 512 after b's release
        return c.view(1000) + a[:1000], d

    traced = D.trace_step(step, (torch.empty(2000, device="meta"),))
    m = traced["memory"]
    assert m["argument_bytes"] == 8192
    # a, b and c (16,384), then b released before d and c + a: a, c, d, c + a
    assert m["peak_bytes"] == 8192 + 4096 + 512 + 4096
    assert m["output_bytes"] == 4096 + 512
