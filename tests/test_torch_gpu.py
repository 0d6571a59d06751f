"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and nvcc (they build the kernels at first use);
without a card they skip. Run them on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX: the card's machine has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.kernels import _lib, ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.distill_loss import distill_loss_batched
from repro_torch.kernels.skr_rectify import (
    skr_process_batched,
    skr_rectify_batched,
    skr_rectify_rows,
)
from repro_torch.kernels.skr_rectify import variant_launches as skr_variants

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _distill_inputs(B, N, V, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((B, N, V), generator=g, device=dev) * 2.0
    t = torch.log_softmax(torch.randn((B, N, V), generator=g, device=dev), -1)
    y = torch.randint(0, V, (B, N), generator=g, device=dev)
    w = torch.randn((B, N), generator=g, device=dev)
    return z, t, y, w


def test_kernels_build_for_sm90a(cuda):
    _, report = _lib.build()
    assert "sm_90a" in report
    assert _lib.lib() is not None


def test_kernel_contract_mirror_holds_on_the_card(cuda):
    """The static analysis's mirror of every kernel instance
    (``repro_torch.analysis.kernel_contracts``) against
    ``cudaFuncGetAttributes``: static and dynamic shared bytes, the opt-in,
    registers within the cap, threads, local bytes only where the table
    says why; KRN003's limit is the card's opt-in limit, and the build
    compiles one entry function per instance. Early in the file, so that
    the backward's opt-in is still the one the main chunk makes."""
    from repro_torch.analysis import kernel_contracts as kc

    props = torch.cuda.get_device_properties(cuda)
    assert props.shared_memory_per_block_optin == kc.DEFAULT_SMEM_LIMIT
    assert _lib.build()[1].count("Compiling entry function") == len(kc.all_instances())
    bad = {f"{c.name} {i.name}": p for c, i in kc.all_instances()
           for p in (kc.card_attrs(c, i)[1],) if p}
    assert bad == {}


# forward within 1e-5 relative: fp32 sums in another order. Gradient within
# 1e-6 absolute plus 1e-5 relative: the two sides' logZ may differ by one
# fp32 ulp (about 1e-6 at logZ ~ 10), which moves every dz element by that
# relative amount, and the largest elements reach a few units here. (1, 128,
# 128256): the LM distillation step's student loss (the stream forward and
# slices backward of the t entry in fp32)
@pytest.mark.parametrize("B,N,V", [(1, 8, 10), (4, 8, 10), (3, 37, 1000),
                                   (4, 256, 2048), (2, 64, 128256), (1, 128, 128256)])
@pytest.mark.parametrize("beta", [0.0, 1.5])
def test_distill_loss_matches_plain(cuda, B, N, V, beta):
    z, t, y, w = _distill_inputs(B, N, V, cuda)
    zk = z.clone().requires_grad_(True)
    loss = distill_loss_batched(zk, t, y, beta, 1.0)
    (dz,) = torch.autograd.grad(loss, zk, w)
    want = R.distill_loss_batched_ref(z, y, t, beta, 1.0)
    want_dz = w[..., None] * R.distill_loss_grad_ref(z, y, t, beta, 1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dz, want_dz, rtol=1e-5, atol=1e-6)


# bf16 logits, as the LM training loss feeds them: the loss (fp32) within
# 1e-5 relative plus 1e-6; dz (bf16) within ref.distill_loss_grad_bf16_bound:
# one bf16 ulp of |want| (both sides round nearly the same fp32 value once),
# and at beta > 0 also 2^-16 of the element's terms that beta's term cancels
@pytest.mark.parametrize("B,N,V", [(1, 8, 10), (3, 37, 1000), (2, 5, 1003), (4, 256, 2048),
                                   (1, 1024, 128256)])
@pytest.mark.parametrize("beta", [0.0, 1.5])
def test_distill_loss_bf16_matches_plain(cuda, B, N, V, beta):
    z, t, y, w = _distill_inputs(B, N, V, cuda)
    z, t = z.bfloat16(), (t if beta else torch.zeros_like(t)).bfloat16()
    zk = z.clone().requires_grad_(True)
    loss = distill_loss_batched(zk, t, y, beta, 1.0)
    (dz,) = torch.autograd.grad(loss, zk, w)
    want = R.distill_loss_batched_ref(z, y, t, beta, 1.0)
    want_dz = R.distill_loss_grad_ref(z, y, t, beta, 1.0, g=w)
    torch.cuda.synchronize()
    assert loss.dtype == torch.float32 and dz.dtype == torch.bfloat16
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    d = (dz.float() - want_dz.float()).abs()
    bound = R.distill_loss_grad_bf16_bound(want_dz, z, t, beta, g=w)
    assert (d <= bound).all(), (d / bound).max()


def _unaligned(x):
    """x's values in a contiguous tensor one element past a 16-byte
    boundary: every row peels a head and a tail."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _held(loss, dz, z, t, y, w, beta):
    want = R.distill_loss_batched_ref(z, y, t, beta, 1.0)
    want_dz = R.distill_loss_grad_ref(z, y, t, beta, 1.0, g=w)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    d = (dz.float() - want_dz.float()).abs()
    if z.dtype == torch.float32:
        bound = 1e-6 + 1e-5 * want_dz.abs()
    else:
        bound = R.distill_loss_grad_bf16_bound(want_dz.float(), z, t, beta, g=w)
    assert (d <= bound).all(), (d / bound).max()


# each kernel at and across its variant's threshold (16 KB rows: fp32 V =
# 4096, bf16 V = 8192), with row counts that fill no whole block (4 rows a
# 128-thread block at 32 threads a row), on logits that start on a 16-byte
# boundary or one element past it; the t entry at beta 0 and 1.5, the CE
# entry at beta 0, which must give the t entry's bits on an all-zero t
@pytest.mark.parametrize("B,N,V,dtype", [
    (1, 5, 10, torch.float32), (3, 7, 513, torch.float32), (1, 33, 4095, torch.float32),
    (1, 33, 4096, torch.float32), (1, 33, 4097, torch.float32), (2, 3, 1003, torch.bfloat16),
    (1, 17, 8191, torch.bfloat16), (1, 17, 8192, torch.bfloat16),
    (1, 17, 8193, torch.bfloat16), (1, 300, 20000, torch.bfloat16),
])
@pytest.mark.parametrize("unaligned", [False, True])
def test_distill_loss_variants_match_plain(cuda, B, N, V, dtype, unaligned):
    from repro_torch.kernels.distill_loss import (
        _bwd_variant,
        _fwd_variant,
        softmax_xent_batched,
        variant_launches,
    )

    z, t, y, w = _distill_inputs(B, N, V, cuda)
    z, t = z.to(dtype), t.to(dtype)
    if unaligned:
        z = _unaligned(z)
    zero = torch.zeros_like(z) if not unaligned else _unaligned(torch.zeros_like(z))
    fwd, bwd = _fwd_variant(B * N, V, dtype)[0], _bwd_variant(V, dtype)[0]
    got = {}
    for entry, tt, beta in (("t", t, 1.5), ("t", zero, 0.0), ("ce", None, 0.0)):
        ops.reset_launches()
        zk = z.detach().clone() if not unaligned else _unaligned(z)
        zk.requires_grad_(True)
        loss = (distill_loss_batched(zk, tt, y, beta, 1.0) if entry == "t"
                else softmax_xent_batched(zk, y))
        (dz,) = torch.autograd.grad(loss, zk, w)
        torch.cuda.synchronize()
        sfx = "" if entry == "t" else "_ce"
        assert {k: n for k, n in variant_launches.items() if n} == {
            f"fwd{sfx}:{fwd}": 1, f"bwd{sfx}:{bwd}": 1}
        _held(loss, dz, z, zero if tt is None else tt, y, w, beta)
        got[(entry, beta)] = (loss, dz)
    assert torch.equal(got[("ce", 0.0)][0], got[("t", 0.0)][0])
    assert torch.equal(got[("ce", 0.0)][1], got[("t", 0.0)][1])


def test_ce_entry_allocates_no_teacher(cuda):
    """At the training shape the CE forward allocates its loss, stats and
    int32 labels, and nothing of the logits' size."""
    from repro_torch.kernels.distill_loss import softmax_xent_batched

    z, _, y, _ = _distill_inputs(1, 1024, 128256, cuda)
    z = z.bfloat16().requires_grad_(True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss = softmax_xent_batched(z, y)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before < z.numel() * 2 // 8
    del loss


def test_distill_loss_entries_refuse_bad_launches(cuda):
    """The C entries return an error, and launch nothing, for a variant
    that does not hold the row."""
    z, _, y, _ = _distill_inputs(1, 4, 5000, cuda)
    y32 = y.to(torch.int32)
    loss = torch.empty((1, 4), device=cuda)
    stats = torch.empty((1, 4, 2), device=cuda)
    with pytest.raises(RuntimeError):  # 5000 fp32 do not fit 256 threads x 64 bytes
        _lib.launch("distill_loss_fwd_ce", cuda, z.data_ptr(), y32.data_ptr(), loss.data_ptr(),
                    stats.data_ptr(), 4, 5000, 1.0, 0, 256, count_as="distill_loss_fwd")
    dz = torch.empty_like(z)
    with pytest.raises(RuntimeError):  # one 16 KB slice for a 20 KB row
        _lib.launch("distill_loss_bwd_ce", cuda, z.data_ptr(), y32.data_ptr(), stats.data_ptr(),
                    loss.data_ptr(), dz.data_ptr(), 4, 5000, 1.0, 256, 1,
                    count_as="distill_loss_bwd")


def test_training_loss_runs_through_the_kernels(cuda):
    """train_lm on the card (reduced llama3.2-3b) with use_kernels: one
    forward and one backward distill_loss launch per loss chunk, finite
    losses, device time in the profiled last step, and the same first-step
    loss as use_kernels=False."""
    from repro_torch.launch.train import train_lm

    ops.reset_launches()
    res = train_lm("llama3.2-3b", steps=3, batch=2, seq=64, use_kernels=True, log_every=1,
                   profile_last=1)
    assert ops.launches["distill_loss_fwd"] == ops.launches["distill_loss_bwd"] == 3
    assert np.isfinite(res.losses).all()
    assert res.profile["busy_s"] > 0 and res.profile["kernels_per_step"] > 0
    plain = train_lm("llama3.2-3b", steps=1, batch=2, seq=64, use_kernels=False)
    np.testing.assert_allclose(res.losses[0], plain.losses[0], rtol=1e-5)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One make_train_step of reduced llama3.2-3b in fp32 from the same
    params and batch: loss 1e-5 relative, grad norm 1e-4 relative."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.loader import token_batches
    from repro_torch.launch.steps import default_opts, make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    cfg = reduced(get_arch("llama3.2-3b"))
    opts = default_opts(cfg, attn_chunk=0, remat=False, use_kernels=True)
    params = init_params(cfg, opts, seed=0, device="cpu")
    b = next(token_batches(np.random.default_rng(0), cfg.vocab_size, 2, 32))
    out = []
    for d in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        batch = {k: torch.from_numpy(v).to(d, torch.int64) for k, v in b.items()}
        _, _, m = make_train_step(cfg, opts, lr=1e-2)(p, adamw_init(p), batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    (lg, gg), (lc, gc) = out
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(gg, gc, rtol=1e-4)


@pytest.mark.parametrize("B,N,C", [(1, 8, 10), (4, 8, 10), (4, 256, 1024)])
def test_skr_rectify_exact(cuda, B, N, C):
    g = torch.Generator(device=cuda).manual_seed(1)
    probs = torch.softmax(torch.randn((B, N, C), generator=g, device=cuda) * 2, -1)
    labels = torch.randint(0, C, (B, N), generator=g, device=cuda)
    qbar = torch.rand((B, C), generator=g, device=cuda) * 0.8 + 0.1
    counts = torch.randint(0, 3, (B, C), generator=g, device=cuda, dtype=torch.int32)
    got = skr_rectify_batched(probs, labels, qbar, counts)
    want = R.skr_rectify_batched_ref(probs, labels, qbar, counts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _skr_state(B, N, C, Bq, dev, classes=None, seed=1):
    """probs, labels (int64, from ``classes`` classes if given, so labels
    repeat and later rows see earlier pushes) and a partly filled queue
    state with heads anywhere."""
    g = torch.Generator(device=dev).manual_seed(seed)
    labels = torch.randint(0, classes or C, (B, N), generator=g, device=dev)
    z = torch.randn((B, N, C), generator=g, device=dev) * 2
    # about half the rows correctly attributed, so that they push
    boost = torch.rand((B, N, 1), generator=g, device=dev) < 0.5
    z.scatter_add_(-1, labels[..., None], boost * 6.0)
    probs = torch.softmax(z, -1)
    q = torch.rand((B, C, Bq), generator=g, device=dev) * 0.8 + 0.1
    count = torch.randint(0, Bq + 1, (B, C), generator=g, device=dev, dtype=torch.int32)
    head = torch.randint(0, Bq, (B, C), generator=g, device=dev, dtype=torch.int32)
    return probs, labels, q, count, head


# count, head and q exact (q only stores copies of p_c); Q within 1e-6: the
# kernel sums a queue in slot order, the plain version with torch.sum
@pytest.mark.parametrize("B,N,C,Bq,classes", [
    (1, 8, 10, 20, None), (4, 8, 10, 20, None), (4, 256, 1024, 20, None),
    (2, 64, 10, 4, 2),      # repeated labels: pushes wrap the heads
    (2, 1500, 10, 20, 3),   # more rows than the kernel's chunk
    # the LM distillation step's teacher step: 128 rows of 128,256 classes,
    # labels over all of them or from 64, every queue partly full (Eq. 31)
    (1, 128, 128256, 20, None), (1, 128, 128256, 20, 64),
])
def test_skr_process_matches_plain(cuda, B, N, C, Bq, classes):
    ins = _skr_state(B, N, C, Bq, cuda, classes)
    got = skr_process_batched(*ins)
    want = R.skr_process_batched_ref(*ins)
    torch.cuda.synchronize()
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (got[0] - want[0]).abs().max().item() <= 1e-6
    # int32 labels take the kernel's other instantiation
    got32 = skr_process_batched(ins[0], ins[1].to(torch.int32), *ins[2:])
    assert all(torch.equal(a, b) for a, b in zip(got, got32))
    _lib.raise_faults(cuda)  # no fault flagged


def test_skr_process_is_one_launch_per_teacher_step(cuda):
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem

    cfg = FLConfig(num_clients=4, num_edges=2, samples_per_client=16,
                   test_samples=64, image_size=8, embed_dim=16)
    _, tree, client_data, auto = build_problem(cfg, device=cuda)
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device=cuda)
    teacher_steps = sum(trainer.pair_steps(s, t) for v, p in trainer.round_pairs()
                        for s, t in ((v, p), (p, v)))
    ops.reset_launches()
    trainer.train_round()
    assert teacher_steps > 0
    assert ops.launches["skr_rectify"] == teacher_steps
    assert skr_variants == {"map": 0, "fused": teacher_steps}


def test_skr_process_raises_on_bad_labels_and_state(cuda):
    """The kernel flags a fault in a pinned word; it raises at the next sync
    on the card: ``_lib.raise_faults``, or on the main path the label check
    of the student step that reads Q."""
    probs, labels, q, count, head = _skr_state(2, 8, 10, 4, cuda)
    for bad in (10, -1):
        y = labels.clone()
        y[1, 3] = bad
        skr_process_batched(probs, y, q, count, head)
        with pytest.raises(ValueError, match="label"):
            _lib.raise_faults(cuda)
    skr_process_batched(probs, labels, q, count + 5, head)
    with pytest.raises(ValueError, match="count"):
        _lib.raise_faults(cuda)
    skr_process_batched(probs, labels, q, count, head + 4)
    with pytest.raises(ValueError, match="head"):
        _lib.raise_faults(cuda)
    y = labels.clone()
    y[0, 0] = 10
    skr_process_batched(probs, y, q, count, head)
    with pytest.raises(ValueError, match="skr_process"):
        _lib.check_labels("distill_loss", labels, 10)
    _lib.raise_faults(cuda)  # reported once: the words are zero again
    with pytest.raises(ValueError):  # non-contiguous probs
        skr_process_batched(probs.transpose(0, 1).contiguous().transpose(0, 1), labels, q,
                            count, head)
    # the card is fine afterwards
    got = skr_process_batched(probs, labels, q, count, head)
    assert torch.equal(got[2], R.skr_process_batched_ref(probs, labels, q, count, head)[2])
    _lib.raise_faults(cuda)


def test_launches_are_counted(cuda):
    ops.reset_launches()
    z, t, y, _ = _distill_inputs(1, 8, 10, cuda)
    zk = z.clone().requires_grad_(True)
    distill_loss_batched(zk, t, y, 1.5, 1.0).sum().backward()
    probs = torch.softmax(z, -1)
    skr_rectify_rows(probs[0], y[0], probs[0, :, 0].contiguous(),
                     torch.ones(8, dtype=torch.bool, device=cuda),
                     torch.full((8,), 0.5, device=cuda))
    assert ops.launches == {"distill_loss_fwd": 1, "distill_loss_bwd": 1, "skr_rectify": 1,
                            "flash_attention": 0, "flash_attention_empty_rows": 0,
                            "rwkv6_scan": 0, "rwkv6_scan_bwd": 0}


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    z, t, y, _ = _distill_inputs(1, 8, 16, cuda)
    with pytest.raises(ValueError):  # non-contiguous logits
        distill_loss_batched(z.transpose(1, 2).contiguous().transpose(1, 2), t, y)
    with pytest.raises(ValueError):  # label out of range
        distill_loss_batched(z, t, torch.full_like(y, 16))
    with pytest.raises(ValueError):  # mixed devices
        distill_loss_batched(z, t.cpu(), y)


def test_fedeec_runs_through_the_kernels(cuda):
    from repro_torch.fl.engine import run_experiment

    cfg = FLConfig(num_clients=4, num_edges=2, samples_per_client=16,
                   test_samples=64, image_size=8, embed_dim=16)
    ops.reset_launches()
    res = run_experiment("fedeec", cfg, rounds=1)
    assert np.isfinite(res.acc_curve).all()
    fedeec_kernels = ("distill_loss_fwd", "distill_loss_bwd", "skr_rectify")
    assert all(ops.launches[k] > 0 for k in fedeec_kernels)


def test_mobile_clients_on_the_card_matches_the_table(cuda):
    """The gate configuration of ``benchmarks/tables/scenarios.json``
    (4 clients, 2 edges, cnn2 edge and cloud, 2 rounds, no eval) through
    ``mobile_clients`` on the card: the tracked signature, with every pair
    through the kernels."""
    import json
    from pathlib import Path

    from repro_torch.configs.fedeec_paper import paper_setting
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.scenarios import get_scenario

    table = json.loads((Path(__file__).resolve().parent.parent / "benchmarks" / "tables"
                        / "scenarios.json").read_text())
    cfg = paper_setting("synth_cifar10", 4, 2, samples_per_client=16, test_samples=64,
                        image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2")
    _, tree, client_data, auto = build_problem(cfg, device=cuda)
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device=cuda)
    engine = SimEngine(trainer, get_scenario("mobile_clients"), seed=cfg.seed)
    ops.reset_launches()
    log = engine.run(2)
    assert log.signature() == table["fedeec/mobile_clients"]
    assert log.count("migrate") > 0
    assert engine.dispatch_stats["batched_dispatches"] > 0
    assert all(ops.launches[k] > 0 for k in ("distill_loss_fwd", "distill_loss_bwd",
                                             "skr_rectify"))


def test_coalesced_group_launches_once_per_group_step(cuda):
    """A coalesced group of leaf pairs on the card: one fused SKR launch a
    teacher step, one distill_loss forward and backward a student step
    (two, the CE entry and the t entry, when the students hold data),
    whatever the group's size."""
    from repro_torch.configs.fedeec_paper import paper_setting
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.kernels.distill_loss import variant_launches as distill_variants
    from repro_torch.sim.engine import plan_groups
    from repro_torch.tree import tree_leaves

    cfg = paper_setting("synth_cifar10", 4, 2, samples_per_client=16, test_samples=64,
                        image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2")
    _, tree, client_data, auto = build_problem(cfg, device=cuda)
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device=cuda)
    items = [it for it in trainer.work_items(0, lambda v: True) if it.node in client_data]
    group = max(plan_groups(items, trainer.batch_signature), key=len)
    assert len(group) >= 2
    k = group[0].steps
    ops.reset_launches()
    trainer.execute_batch(group)
    _lib.raise_faults(cuda)
    # child as student: the CE entry and the t entry a step; parent: the t entry
    assert ops.launches["distill_loss_fwd"] == ops.launches["distill_loss_bwd"] == 3 * k
    assert distill_variants["fwd_ce:regs"] == distill_variants["bwd_ce:rows"] == k
    assert distill_variants["fwd:regs"] == distill_variants["bwd:rows"] == 2 * k
    assert ops.launches["skr_rectify"] == 2 * k
    assert skr_variants == {"map": 0, "fused": 2 * k}
    for it in group:
        for v in (it.node, it.peer):
            assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(trainer.params[v]))


def test_traced_pair_spans_equal_the_dispatch_counts(cuda):
    """One leaf pair on the card under a tracer: a ``kernel.<op>`` span per
    op call, as many as ``kernel_dispatch_seconds{kernel=<op>}`` observed;
    the forward ops' spans equal distill_loss's forward launches and the
    ``skr_process*`` spans the fused entry's launches (the backward
    launches inside ``loss.backward()``, outside any span)."""
    from collections import Counter

    from repro_torch.configs.fedeec_paper import paper_setting
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.obs.metrics import global_registry
    from repro_torch.obs.trace import Tracer, tracing

    cfg = paper_setting("synth_cifar10", 4, 2, samples_per_client=16, test_samples=64,
                        image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2")
    _, tree, client_data, auto = build_problem(cfg, device=cuda)
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device=cuda)
    item = next(it for it in trainer.work_items(0, lambda v: True) if it.node in client_data)
    labels = ("softmax_xent", "softmax_xent_batched", "distill_loss", "distill_loss_batched",
              "skr_process", "skr_process_batched")
    hist = {k: global_registry().histogram("kernel_dispatch_seconds", kernel=k)
            for k in labels}
    before = {k: h.count for k, h in hist.items()}
    ops.reset_launches()
    tr = Tracer()
    with tracing(tr):
        trainer.execute(item)
    torch.cuda.synchronize()
    spans = Counter(sp.name[len("kernel."):] for sp in tr.spans if sp.cat == "kernel")
    assert set(spans) <= set(labels) and sum(spans.values()) > 0
    for k in labels:
        assert spans[k] == hist[k].count - before[k], k
    assert sum(spans[k] for k in labels[:4]) == ops.launches["distill_loss_fwd"] > 0
    assert spans["skr_process"] + spans["skr_process_batched"] \
        == skr_variants["fused"] == ops.launches["skr_rectify"] > 0


@pytest.mark.parametrize("leaf", [False, True])
@pytest.mark.parametrize("name", ["cnn1", "resnet10", "resnet18"])
def test_coalesced_step_gradients_match_the_cpu(cuda, name, leaf):
    """One coalesced student step (B = 3, the model through
    ``torch.func.vmap``, the losses through the kernels' (B, N, V) entries)
    on the card against the CPU's, from the same parameters and inputs:
    each pair's loss within 1e-5 relative, the stacked gradient within 1e-5
    absolute (``chip_smoke.py``'s bounds for one student step). The models
    run in fp64 and their logits enter the fp32 loss: in fp32 the card's
    grouped convolutions and the CPU's round differently by about 3e-6, and
    a pre-activation that close to ReLU's kink takes the other branch on
    one device, which moves the gradients below that ReLU by up to 1e-3 of
    their scale (seen at resnet18 on these inputs); in fp64 no
    pre-activation lies that close, so the bound holds the batched path
    itself (stacking, the vmapped backward, the kernels' entries)."""
    from repro_torch.core import bsbodp
    from repro_torch.core.fedeec import node_generator
    from repro_torch.models.registry import get_fl_model
    from repro_torch.tree import tree_leaves, tree_map, tree_stack, value_and_grad

    B = 3
    rng = np.random.default_rng(1)
    x = rng.random((B, 8, 16, 16, 3))
    lx = rng.random((B, 8, 16, 16, 3))
    y, ly = rng.integers(0, 10, (B, 8)), rng.integers(0, 10, (B, 8))
    q = rng.random((B, 8, 10)).astype(np.float32) ** 3
    q /= q.sum(-1, keepdims=True)
    init, apply = get_fl_model(name)
    vapply = torch.func.vmap(apply)
    apply = lambda p, a: vapply(p, a).float()
    P = tree_map(torch.Tensor.double,
                 tree_stack([init(node_generator(1, b), 10, 16) for b in range(B)]))
    out = {}
    for d in (cuda, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a).to(d)
        if leaf:
            fn = lambda pp: bsbodp.leaf_loss_batched(apply(pp, t(lx)), t(ly), apply(pp, t(x)),
                                                     t(y), t(q), 1.5, 1.0)
        else:
            fn = lambda pp: bsbodp.non_leaf_loss_batched(apply(pp, t(x)), t(y), t(q), 1.5)
        pp = tree_map(lambda a: a.to(d), P)
        with torch.no_grad():
            losses = fn(pp).cpu()
        _, g = value_and_grad(lambda p: fn(p).sum(), pp)
        out[d.type] = (losses, [a.cpu() for a in tree_leaves(g)])
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=0)
    assert max((a - b).abs().max().item() for a, b in zip(gg, gc)) <= 1e-5


# --- the LM serving kernels ---------------------------------------------------


def _attn_inputs(B, Sq, Sk, N, K, H, dtype, dev, seed=0, Hv=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=dev).mul_(0.5).to(dtype)
                 for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, Hv or H)))


# fp32 within 3e-5 (sums in another order: the JAX kernel tests' bound);
# bf16 within one bf16 ulp of each element, 2^-7 |want| + 1e-6 (both sides
# compute in fp32 and round once)
@pytest.mark.parametrize("B,Sq,Sk,N,K,H,causal,window,q_offset", [
    (2, 32, 32, 4, 2, 32, True, 0, 0),
    (1, 64, 64, 8, 8, 64, True, 0, 0),
    (2, 32, 32, 4, 1, 32, True, 8, 0),
    (1, 16, 64, 4, 2, 32, True, 0, 48),
    (2, 24, 24, 2, 2, 128, False, 0, 0),
    (2, 40, 100, 4, 2, 64, True, 24, 60),
    (1, 17, 33, 2, 1, 256, True, 0, 16),
    (8, 1, 300, 24, 8, 128, True, 0, 130),  # decode against a longer cache
    # head_dim 64 non-causal, as whisper-small's encoder and cross attention
    # run it: Sq * G and Sk ragged; Sq > Sk
    (1, 77, 100, 12, 12, 64, False, 0, 0),
    (2, 300, 70, 6, 2, 64, False, 0, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, B, Sq, Sk, N, K, H, causal, window, q_offset,
                                       dtype):
    q, k, v = _attn_inputs(B, Sq, Sk, N, K, H, dtype, cuda)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = (2.0**-7, 1e-6) if dtype == torch.bfloat16 else (0.0, 3e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# the tensor-core kernel's edges (128 rows, 64 keys a tile), as in
# chip_smoke.py, and the llama3.2-3b prefill shape; then the head_dim 256
# instance (TMA producer) at gemma3-12b's G = 2: ragged rows, ragged keys
# with q_offset, a window across tile edges with q_offset, non-causal, G = 3
# (128 % G != 0), and gemma3-12b's global and local layers at one
# 4096-token prompt; bound as above
@pytest.mark.parametrize("B,Sq,Sk,N,K,H,causal,window,q_offset", [
    (1, 77, 77, 24, 8, 128, True, 0, 0),
    (2, 40, 100, 6, 2, 128, True, 0, 60),
    (1, 200, 200, 8, 2, 64, True, 70, 0),
    (1, 96, 160, 8, 2, 128, False, 0, 0),
    (2, 300, 300, 4, 4, 64, True, 0, 0),
    (1, 4096, 4096, 24, 8, 128, True, 0, 0),
    (1, 77, 77, 4, 2, 256, True, 0, 0),
    (2, 40, 100, 4, 2, 256, True, 0, 60),
    (1, 300, 400, 4, 2, 256, True, 70, 100),
    (1, 96, 160, 8, 4, 256, False, 0, 0),
    (2, 77, 77, 6, 2, 256, True, 0, 0),
    (1, 4096, 4096, 16, 8, 256, True, 0, 0),
    (1, 4096, 4096, 16, 8, 256, True, 1024, 0),
    # the (112, 112) instance (zamba2-7b's shared attention block: rows of
    # 14 units in 128-wide tiles): the same edges, then its 4096-token
    # prompt at 32 heads
    (1, 77, 77, 4, 4, 112, True, 0, 0),
    (2, 40, 100, 4, 2, 112, True, 0, 60),
    (1, 200, 200, 8, 8, 112, True, 70, 0),
    (1, 96, 160, 8, 4, 112, False, 0, 0),
    (1, 4096, 4096, 32, 32, 112, True, 0, 0),
    # the (64, 64) instance non-causal (the last row tile's and key tile's
    # edges, Sq > Sk), then whisper-small's prefill step (12 heads, MHA):
    # the encoder over 1500 frames and the cross attention over them,
    # non-causal, and the decoder's 4096 tokens, causal
    (1, 77, 100, 12, 12, 64, False, 0, 0),
    (2, 300, 70, 6, 2, 64, False, 0, 0),
    (1, 1500, 1500, 12, 12, 64, False, 0, 0),
    (1, 4096, 1500, 12, 12, 64, False, 0, 0),
    (1, 4096, 4096, 12, 12, 64, True, 0, 0),
    # the LM distillation step's teacher prefill (llama3.2-3b, 4 x 32
    # tokens): every 128-row query tile partial
    (4, 32, 32, 24, 8, 128, True, 0, 0),
])
def test_flash_attention_sm90_matches_plain(cuda, B, Sq, Sk, N, K, H, causal, window,
                                            q_offset):
    from repro_torch.kernels.flash_attention import sm90_launches, variant_launches

    q, k, v = _attn_inputs(B, Sq, Sk, N, K, H, torch.bfloat16, cuda)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert variant_launches == {"sm90": 1, "tf32x3": 0, "decode": 0, "latent_decode": 0}
    assert sm90_launches[(H, H)] == 1 and sum(sm90_launches.values()) == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=1e-6)


def test_flash_attention_sm90_instances_spill_nothing(cuda):
    """cudaFuncGetAttributes: no local (spill or stack) bytes in any of the
    tensor-core kernel's instances."""
    from repro_torch.kernels.flash_attention import SM90_INSTANCES, sm90_attrs

    for H, Hv in SM90_INSTANCES:
        regs, local = sm90_attrs(H, Hv)
        assert 0 < regs <= 255 and local == 0, (H, Hv, regs, local)
    with pytest.raises(RuntimeError):
        sm90_attrs(32, 32)
    with pytest.raises(RuntimeError):
        sm90_attrs(48, 32)


# the 3xTF32 kernel (csrc/flash_attention.cu) at head_dim 256 in fp32 (64
# rows a block, 32-key tiles): ragged rows and keys with q_offset, and a
# window across tile edges; within 3e-5
@pytest.mark.parametrize("B,Sq,Sk,N,K,H,causal,window,q_offset", [
    (1, 77, 100, 4, 2, 256, True, 0, 23),
    (1, 200, 200, 8, 2, 256, True, 70, 0),
])
def test_flash_attention_tf32x3_fp32_h256_matches_plain(cuda, B, Sq, Sk, N, K, H, causal,
                                                        window, q_offset):
    from repro_torch.kernels.flash_attention import variant_launches

    q, k, v = _attn_inputs(B, Sq, Sk, N, K, H, torch.float32, cuda)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert variant_launches == {"sm90": 0, "tf32x3": 1, "decode": 0, "latent_decode": 0}
    torch.testing.assert_close(got, want, rtol=0.0, atol=3e-5)


# the 3xTF32 kernel's (112, 112) instance in fp32 (64 rows a block, 32-key
# tiles; the card-vs-CPU parities of zamba2-7b run it): ragged rows and
# keys with q_offset, a window, and the 4096-token prompt; within 3e-5
@pytest.mark.parametrize("B,Sq,Sk,N,K,H,causal,window,q_offset", [
    (1, 77, 100, 4, 4, 112, True, 0, 23),
    (1, 200, 200, 8, 2, 112, True, 70, 0),
    (1, 4096, 4096, 32, 32, 112, True, 0, 0),
])
def test_flash_attention_tf32x3_fp32_h112_matches_plain(cuda, B, Sq, Sk, N, K, H, causal,
                                                        window, q_offset):
    from repro_torch.kernels.flash_attention import variant_launches

    q, k, v = _attn_inputs(B, Sq, Sk, N, K, H, torch.float32, cuda)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert variant_launches == {"sm90": 0, "tf32x3": 1, "decode": 0, "latent_decode": 0}
    torch.testing.assert_close(got, want, rtol=0.0, atol=3e-5)


# decode shapes (one query), which the wrapper sends to the split-KV
# kernel, launched directly on the 3xTF32 kernel in fp32: llama3.2-3b's
# step against a full 4096-long cache, and G = 1 at head_dim 32; within 3e-5
@pytest.mark.parametrize("B,Sk,N,K,H,q_offset", [(8, 4096, 24, 8, 128, 4095),
                                                 (2, 300, 8, 8, 32, 299)])
def test_flash_attention_tf32x3_launched_at_decode_matches_plain(cuda, B, Sk, N, K, H,
                                                                 q_offset):
    q, k, v = _attn_inputs(B, 1, Sk, N, K, H, torch.float32, cuda)
    got = torch.empty_like(q)
    _lib.launch("flash_attention", cuda, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                got.data_ptr(), B, 1, Sk, N, K, H, H, 0, 1, 0, q_offset, Sk, float(H**-0.5))
    want = R.flash_attention_ref(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0.0, atol=3e-5)


def test_flash_attention_tf32x3_instances_spill_nothing(cuda):
    """cudaFuncGetAttributes: no local (spill or stack) bytes in the 3xTF32
    kernel's instances, in fp32 and bf16, but the bf16 one at head_dim 256
    (reached only by a direct launch), which builds within a thread's 255
    registers."""
    from repro_torch.kernels.flash_attention import TF32X3_INSTANCES, tf32x3_attrs

    for dtype in (torch.float32, torch.bfloat16):
        for H, Hv in TF32X3_INSTANCES:
            regs, local = tf32x3_attrs(H, Hv, dtype)
            assert 0 < regs <= 255, (H, Hv, dtype, regs)
            if not (H == 256 and dtype == torch.bfloat16):
                assert local == 0, (H, Hv, dtype, regs, local)
    with pytest.raises(RuntimeError):
        tf32x3_attrs(48, 48, torch.float32)
    with pytest.raises(RuntimeError):
        tf32x3_attrs(48, 32, torch.float32)


# the split-KV decode kernel: the CPU emulation's cases
# (tests/test_torch_flash_decode.py) and llama3.2-3b's decode step against
# a 4096-long cache at positions 0, 63 and 4095; bound as above
DECODE_CASES = [
    (2, 300, 8, 8, 32, True, 0, 299),
    (2, 700, 6, 2, 64, True, 0, 650),
    (1, 1000, 4, 1, 128, True, 100, 900),
    (1, 1500, 16, 2, 256, True, 0, 1499),
    (1, 600, 24, 8, 128, True, 0, 700),
    (1, 1200, 8, 2, 128, True, 700, 1100),
    (2, 300, 4, 2, 32, False, 0, 5),
    (1, 520, 16, 1, 64, True, 24, 400),
    (1, 520, 16, 1, 64, True, 0, 519),
    (8, 4096, 24, 8, 128, True, 0, 0),
    (8, 4096, 24, 8, 128, True, 0, 63),
    (8, 4096, 24, 8, 128, True, 0, 4095),
    # gemma3-12b's decode steps: 16/8 heads of 256, the global layers and
    # the local layers' 1024-key window, in the serving run and at a full
    # cache
    (8, 4096, 16, 8, 256, True, 0, 63),
    (8, 4096, 16, 8, 256, True, 0, 4095),
    (8, 4096, 16, 8, 256, True, 1024, 63),
    (8, 4096, 16, 8, 256, True, 1024, 4095),
    # zamba2-7b's shared attention block, 32 heads of 112 (a key row on 16
    # lanes in bf16, 32 in fp32, some idle): the serving batch at positions
    # 0, 63, 100 (a range that ends inside a 64-key step) and 4095, then
    # several splits and a window at G = 2 and 1
    (8, 4096, 32, 32, 112, True, 0, 0),
    (8, 4096, 32, 32, 112, True, 0, 63),
    (8, 4096, 32, 32, 112, True, 0, 100),
    (8, 4096, 32, 32, 112, True, 0, 4095),
    (1, 700, 4, 2, 112, True, 0, 650),
    (2, 1000, 8, 8, 112, True, 100, 900),
    # whisper-small, 12 heads of 64, MHA: the self-attention of the serving
    # batch against its 4096-long cache at positions 0, 63 and 4095, and
    # the cross attention over 1500 frames (non-causal: 6 splits, the last
    # 220 keys) and over 200 (one split)
    (8, 4096, 12, 12, 64, True, 0, 0),
    (8, 4096, 12, 12, 64, True, 0, 63),
    (8, 4096, 12, 12, 64, True, 0, 4095),
    (8, 1500, 12, 12, 64, False, 0, 0),
    (8, 200, 12, 12, 64, False, 0, 0),
]


@pytest.mark.parametrize("B,Sk,N,K,H,causal,window,q_offset", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_matches_plain(cuda, B, Sk, N, K, H, causal, window, q_offset,
                                              dtype):
    from repro_torch.kernels.flash_attention import variant_launches

    q, k, v = _attn_inputs(B, 1, Sk, N, K, H, dtype, cuda)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = R.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert variant_launches == {"sm90": 0, "tf32x3": 0, "decode": 1, "latent_decode": 0}
    assert got.dtype == dtype
    rtol, atol = (2.0**-7, 1e-6) if dtype == torch.bfloat16 else (0.0, 3e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("q_offset", [63, 4095])
def test_flash_attention_decode_repeats_bitwise(cuda, q_offset):
    """The merge runs in a fixed split order: two calls give the same bits."""
    q, k, v = _attn_inputs(8, 1, 4096, 24, 8, 128, torch.bfloat16, cuda)
    a = ops.flash_attention(q, k, v, q_offset=q_offset)
    b = ops.flash_attention(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# ROADMAP C8: rows whose visible key range is empty (a window that ends
# before the keys do) get the mean of v over every key, as the plain version
# and the reference's jnp mha give; the Pallas kernel writes 0 there. One
# case per kernel the wrapper picks, each followed by the empty-row kernel;
# bound as above
@pytest.mark.parametrize("B,Sq,Sk,N,K,H,window,q_offset,dtype,variant", [
    (2, 1, 33, 6, 2, 64, 8, 100, torch.float32, "decode"),
    (2, 1, 33, 6, 2, 64, 8, 100, torch.bfloat16, "decode"),
    (1, 64, 64, 8, 2, 32, 8, 40, torch.float32, "tf32x3"),
    (1, 128, 100, 24, 8, 128, 16, 40, torch.bfloat16, "sm90"),
    (1, 128, 100, 4, 2, 256, 16, 40, torch.bfloat16, "sm90"),
])
def test_flash_attention_with_no_visible_key_averages_v(cuda, B, Sq, Sk, N, K, H, window,
                                                        q_offset, dtype, variant):
    from repro_torch.kernels.flash_attention import variant_launches

    q, k, v = _attn_inputs(B, Sq, Sk, N, K, H, dtype, cuda)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, window=window, q_offset=q_offset)
    want = R.flash_attention_ref(q, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert variant_launches[variant] == 1 and sum(variant_launches.values()) == 1
    assert ops.launches["flash_attention_empty_rows"] == 1
    rtol, atol = (2.0**-7, 1e-6) if dtype == torch.bfloat16 else (0.0, 3e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_forward_only_kernels_refuse_inputs_that_require_grad(cuda):
    q, k, v = _attn_inputs(1, 8, 8, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        ops.flash_attention(q, k, v)


def test_flash_attention_decode_failed_launch_raises(cuda):
    q, k, v = _attn_inputs(1, 1, 64, 2, 1, 32, torch.float32, cuda)
    o = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    with pytest.raises(RuntimeError):  # a head_dim it does not take: nothing launched
        _lib.launch("flash_attention_decode", cuda, *args, 0, 1, 64, 2, 1, 48, 0, 1, 0, 63,
                    64, 48**-0.5, 256, 1)
    with pytest.raises(RuntimeError):  # two splits and no workspace
        _lib.launch("flash_attention_decode", cuda, *args, 0, 1, 64, 2, 1, 32, 0, 1, 0, 63,
                    64, 32**-0.5, 32, 2)


def test_flash_attention_variants_are_counted(cuda):
    from repro_torch.kernels.flash_attention import variant_launches

    ops.reset_launches()
    prefill = _attn_inputs(1, 16, 16, 6, 2, 128, torch.bfloat16, cuda)
    ops.flash_attention(*prefill)  # bf16 prefill: tensor cores
    ops.flash_attention(*_attn_inputs(2, 1, 16, 6, 2, 128, torch.bfloat16, cuda),
                        q_offset=7)  # decode: split-KV
    ops.flash_attention(*(t.float() for t in prefill))  # fp32
    ops.flash_attention(*_attn_inputs(1, 16, 16, 6, 2, 32, torch.bfloat16, cuda))  # H = 32
    assert variant_launches == {"sm90": 1, "tf32x3": 2, "decode": 1, "latent_decode": 0}
    assert ops.launches["flash_attention"] == 4


# deepseek-v2-lite-16b's MLA: the expanded prefill's (192, 128) instances
# (q and k 128 nope + 64 rope, v 128, 16 heads of one kv head each) at its
# 4096-token prompt, the parity's 128 tokens and the instances' edges; bf16
# within one bf16 ulp of |want| through the tensor-core kernel, fp32 within
# 3e-5 through the 3xTF32 kernel
@pytest.mark.parametrize("B,Sq,Sk,N,K,causal,q_offset", [
    (1, 4096, 4096, 16, 16, True, 0),
    (1, 128, 128, 16, 16, True, 0),
    (1, 77, 77, 16, 16, True, 0),
    (2, 40, 100, 16, 16, True, 60),
    (1, 96, 160, 4, 1, False, 0),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_mla_prefill_matches_plain(cuda, B, Sq, Sk, N, K, causal, q_offset,
                                                   dtype):
    from repro_torch.kernels.flash_attention import sm90_launches, variant_launches

    q, k, v = _attn_inputs(B, Sq, Sk, N, K, 192, dtype, cuda, Hv=128)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = R.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.shape == (B, Sq, N, 128) and got.dtype == dtype
    if dtype == torch.bfloat16:
        assert variant_launches["sm90"] == 1 and sm90_launches[(192, 128)] == 1
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7, atol=1e-6)
    else:
        assert variant_launches["tf32x3"] == 1 and sum(sm90_launches.values()) == 0
        torch.testing.assert_close(got, want, rtol=0.0, atol=3e-5)


def _latent_inputs(B, S, N, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, N, 576), generator=g, device=dev).mul_(0.5)
    kv = torch.randn((B, S, 576), generator=g, device=dev).mul_(0.5).to(dtype)
    return q, kv[..., :512], kv[..., 512:]


# MLA's absorbed decode through the latent decode kernel at deepseek's
# dims (16 heads, 512 + 64): the serving batch against a 4096-row cache at
# q_offset 0, 63 and 127 (splits of 64 keys, the value columns across
# blocks), 50 (a range that ends inside an iteration), 4095 and past the
# cache, one sequence at 4095 (16 splits x 4 value-column groups), a short
# cache, fewer heads, a bf16 or fp32 cache; within 3e-5 of the plain
# version (the kernel's split products are fp32-accurate)
@pytest.mark.parametrize("B,S,N,q_offset", [(8, 4096, 16, 0), (8, 4096, 16, 63),
                                            (8, 4096, 16, 4095), (8, 4096, 16, 5000),
                                            (2, 300, 16, 100), (3, 1000, 5, 777),
                                            (8, 4096, 16, 127), (8, 4096, 16, 50),
                                            (1, 4096, 16, 4095)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_latent_decode_matches_plain(cuda, B, S, N, q_offset, dtype):
    from repro_torch.kernels.flash_attention import variant_launches

    q, ckv, krope = _latent_inputs(B, S, N, dtype, cuda, seed=q_offset)
    ops.reset_launches()
    got = ops.latent_decode(q, ckv, krope, scale=192**-0.5, q_offset=q_offset)
    want = R.latent_decode_ref(q, ckv, krope, scale=192**-0.5, q_offset=q_offset)
    torch.cuda.synchronize()
    assert variant_launches["latent_decode"] == 1 and ops.launches["flash_attention"] == 1
    assert got.shape == (B, 1, N, 512) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0.0, atol=3e-5)
    # two buffers in place of views of one: the same bits
    two = ops.latent_decode(q, ckv.contiguous(), krope.contiguous(), scale=192**-0.5,
                            q_offset=q_offset)
    torch.cuda.synchronize()
    assert torch.equal(two, got)


def test_latent_decode_kernel_uses_no_local_memory(cuda):
    """The latent decode kernel keeps its fragments and accumulators in
    registers for both cache dtypes: no spill or stack bytes."""
    from repro_torch.kernels.flash_attention import latent_decode_attrs

    for dtype in (torch.bfloat16, torch.float32):
        regs, local = latent_decode_attrs(dtype)
        assert 0 < regs <= 255 and local == 0


def test_latent_decode_and_mla_prefill_at_the_reduced_dims_raise(cuda):
    """The reduced config's MLA dims (q and k 48, v 32; latent 32 + 16)
    have no CUDA instance: each call raises, nothing is launched."""
    ops.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _attn_inputs(1, 16, 16, 4, 4, 48, dtype, cuda, Hv=32)
        with pytest.raises(ValueError, match="takes"):
            ops.flash_attention(q, k, v)
    g = torch.Generator(device=cuda).manual_seed(0)
    kv = torch.randn((2, 16, 48), generator=g, device=cuda)
    q = torch.randn((2, 1, 4, 48), generator=g, device=cuda)
    with pytest.raises(ValueError, match="takes"):
        ops.latent_decode(q, kv[..., :32], kv[..., 32:], scale=48**-0.5, q_offset=3)
    assert ops.launches["flash_attention"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_on_the_card_matches_the_cpu(cuda, dtype):
    """Reduced zamba2-7b at the shared attention block's head_dim 112 (4
    heads, MHA) and n_repeats 2: (5 mamba2 + the shared block) twice and a
    tail mamba2. Prefill logits and 6 decode steps' on the card against the
    CPU from the same params, within 1e-4 of max|logit| in fp32 (TF32 off);
    finite in bf16. The shared block's two occurrences launch the (112,
    112) prefill instance (3xTF32 in fp32, tensor cores in bf16) and the
    decode kernel, one launch each a step."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import sm90_launches, variant_launches
    from repro_torch.models.transformer import (
        ModelOpts,
        forward_decode,
        forward_prefill,
        init_cache,
        init_params,
    )
    from repro_torch.tree import tree_map

    cfg = replace(reduced(get_arch("zamba2-7b")), num_heads=4, num_kv_heads=4, head_dim=112,
                  n_repeats=2, num_layers=13, param_dtype=dtype, compute_dtype=dtype)
    dt = getattr(torch, dtype)
    opts = ModelOpts()
    params = init_params(cfg, opts, seed=0, device="cpu")
    toks = torch.randint(1, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(1))
    out = {}
    for d in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        ops.reset_launches()
        pre = forward_prefill(cfg, opts, p, {"tokens": toks.to(d)})
        cache = init_cache(cfg, opts, 2, 8, dt, device=d)
        steps = [forward_decode(cfg, opts, p, {"token": toks[:, t:t + 1].to(d), "pos": t},
                                cache)[0] for t in range(6)]
        out[d.type] = (pre.float().cpu(), torch.stack(steps).float().cpu(),
                       dict(variant_launches), dict(sm90_launches))
    (pre_g, dec_g, launched, inst), (pre_c, dec_c, _, _) = out["cuda"], out["cpu"]
    assert launched == {"sm90": 2 * (dtype == "bfloat16"), "tf32x3": 2 * (dtype == "float32"),
                        "decode": 12, "latent_decode": 0}
    assert inst[(112, 112)] == 2 * (dtype == "bfloat16")
    for g, c in ((pre_g, pre_c), (dec_g, dec_c)):
        assert torch.isfinite(g).all()
        if dtype == "float32":
            assert (g - c).abs().max().item() <= 1e-4 * c.abs().max().item()


@pytest.mark.parametrize("ssm_seq_chunk", [0, 32])
def test_zamba2_train_step_on_the_card_matches_the_cpu(cuda, ssm_seq_chunk):
    """Reduced zamba2-7b with n_repeats 2 ((5 mamba2 + the shared block)
    twice and a tail mamba2: the shared block's gradient summed over two
    occurrences), fp32, the repeats checkpointed, the loss through the CE
    entry on the card: one make_train_step and the gradients from the same
    params and a 2 x 64 batch on the card and on the CPU. Loss 1e-5
    relative, grad norm 1e-4 relative, every gradient leaf (the shared
    block's included) within 1e-4 of its max|g|; on the card one CE launch
    each way and no other kernel of the repo."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.loader import token_batches
    from repro_torch.launch.steps import default_opts, make_train_step
    from repro_torch.models.transformer import forward_train, init_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad

    cfg = replace(reduced(get_arch("zamba2-7b")), n_repeats=2, num_layers=13)
    opts = default_opts(cfg, attn_chunk=0, remat=True, use_kernels=True,
                        ssm_seq_chunk=ssm_seq_chunk)
    params = init_params(cfg, opts, seed=0, device="cpu")
    b = next(token_batches(np.random.default_rng(0), cfg.vocab_size, 2, 64))
    out = {}
    for d in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        batch = {k: torch.from_numpy(v).to(d, torch.int64) for k, v in b.items()}
        ops.reset_launches()
        _, g = value_and_grad(lambda pp: forward_train(cfg, opts, pp, batch)[0], p)
        launched = {k: n for k, n in ops.launches.items() if n}
        _, _, m = make_train_step(cfg, opts, lr=1e-3)(p, adamw_init(p), batch)
        out[d.type] = (float(m["loss"]), float(m["grad_norm"]),
                       [t.cpu() for t in tree_leaves(g)], launched)
    (lg, ng, gg, launched), (lc, nc, gc, _) = out["cuda"], out["cpu"]
    assert launched == {"distill_loss_fwd": 1, "distill_loss_bwd": 1}
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(ng, nc, rtol=1e-4)
    for a, c in zip(gg, gc):
        assert (a - c).abs().max() <= 1e-4 * c.abs().max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-mistral-7b"])
def test_enc_dec_and_media_on_the_card_match_the_cpu(cuda, arch, dtype):
    """Reduced whisper-small at its head_dim 64 (4 heads, MHA: two encoder
    layers over 32 random frames, one decoder layer with cross attention)
    and reduced llava-next-mistral-7b at its head_dim 128 (a prefill with 16
    media rows). Prefill logits and 6 decode steps' (whisper's against
    random encoder states) on the card against the CPU from the same
    params, within 1e-4 of max|logit| in fp32 (TF32 off); finite in bf16.
    Every attention launches one kernel: whisper's prefill step 2 encoder
    layers, a self and a cross attention (the (64, 64) prefill instance in
    bf16, 3xTF32 in fp32), each decode step a self and a cross attention on
    the decode kernel."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import sm90_launches, variant_launches
    from repro_torch.models.transformer import (
        ModelOpts,
        forward_decode,
        forward_prefill,
        init_cache,
        init_params,
    )
    from repro_torch.tree import tree_map

    H = 64 if arch == "whisper-small" else 128
    cfg = replace(reduced(get_arch(arch)), num_heads=4, num_kv_heads=4, head_dim=H,
                  param_dtype=dtype, compute_dtype=dtype)
    dt = getattr(torch, dtype)
    opts = ModelOpts()
    params = init_params(cfg, opts, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (2, 40), generator=g)
    stubs = ({"frames": torch.randn((2, cfg.enc_seq_len, cfg.d_model), generator=g)}
             if cfg.enc_dec else
             {"media": torch.randn((2, cfg.num_media_tokens, cfg.d_model), generator=g)})
    enc = torch.randn((2, cfg.enc_seq_len, cfg.d_model), generator=g)
    out = {}
    for d in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        ops.reset_launches()
        pre = forward_prefill(cfg, opts, p, {"tokens": toks.to(d),
                                             **{k: t.to(d, dt) for k, t in stubs.items()}})
        cache = init_cache(cfg, opts, 2, 8, dt, device=d)
        if cfg.enc_dec:
            cache["enc_out"].copy_(enc)
        steps = [forward_decode(cfg, opts, p, {"token": toks[:, t:t + 1].to(d), "pos": t},
                                cache)[0] for t in range(6)]
        out[d.type] = (pre.float().cpu(), torch.stack(steps).float().cpu(),
                       dict(variant_launches), dict(sm90_launches))
    (pre_g, dec_g, launched, inst), (pre_c, dec_c, _, _) = out["cuda"], out["cpu"]
    n_pre, n_dec = (4, 12) if cfg.enc_dec else (1, 6)
    assert launched == {"sm90": n_pre * (dtype == "bfloat16"),
                        "tf32x3": n_pre * (dtype == "float32"), "decode": n_dec,
                        "latent_decode": 0}
    assert inst[(H, H)] == n_pre * (dtype == "bfloat16")
    for g_, c in ((pre_g, pre_c), (dec_g, dec_c)):
        assert torch.isfinite(g_).all()
        if dtype == "float32":
            V = cfg.vocab_size
            assert (g_ - c)[..., :V].abs().max().item() <= 1e-4 * c[..., :V].abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_layers_on_the_card_match_the_cpu(cuda, dtype):
    """Reduced deepseek-v2-lite-16b at full MLA dims (16 heads; q and k 128
    + 64, v 128; latent 512 + 64), two layers (``mla``, ``mla_moe``): the
    prefill logits and 6 decode steps' on the card against the CPU from the
    same params, within 1e-4 of max|logit| in fp32 (TF32 off); in bf16
    finite (its products round otherwise on the two devices). Both go
    through the (192, 128) prefill instance (3xTF32 in fp32, tensor cores
    in bf16) and the latent decode kernel, one launch a layer and step."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import variant_launches
    from repro_torch.models.transformer import (
        ModelOpts,
        forward_decode,
        forward_prefill,
        init_cache,
        init_params,
    )
    from repro_torch.tree import tree_map

    cfg = replace(reduced(get_arch("deepseek-v2-lite-16b")), num_heads=16, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, param_dtype=dtype,
                  compute_dtype=dtype)
    dt = getattr(torch, dtype)
    opts = ModelOpts()
    params = init_params(cfg, opts, seed=0, device="cpu")
    toks = torch.randint(1, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    out = {}
    for d in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d), params)
        ops.reset_launches()
        pre = forward_prefill(cfg, opts, p, {"tokens": toks.to(d)})
        cache = init_cache(cfg, opts, 2, 8, dt, device=d)
        steps = [forward_decode(cfg, opts, p, {"token": toks[:, t:t + 1].to(d), "pos": t},
                                cache)[0] for t in range(6)]
        out[d.type] = (pre.float().cpu(), torch.stack(steps).float().cpu(),
                       dict(variant_launches))
    (pre_g, dec_g, launched), (pre_c, dec_c, _) = out["cuda"], out["cpu"]
    assert launched == {"sm90": 2 * (dtype == "bfloat16"), "tf32x3": 2 * (dtype == "float32"),
                        "decode": 0, "latent_decode": 12}
    for g, c in ((pre_g, pre_c), (dec_g, dec_c)):
        assert torch.isfinite(g).all()
        if dtype == "float32":
            assert (g - c).abs().max().item() <= 1e-4 * c.abs().max().item()


def test_flash_attention_sm90_rejects_other_head_dims(cuda):
    q, k, v = _attn_inputs(1, 16, 16, 2, 1, 32, torch.bfloat16, cuda)
    o = torch.empty_like(q)
    with pytest.raises(RuntimeError):  # cudaErrorInvalidValue, nothing launched
        _lib.launch("flash_attention_sm90", cuda, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), 1, 16, 16, 2, 1, 32, 32, 1, 0, 0, 16, 32**-0.5)
    with pytest.raises(RuntimeError):  # (192, 64): no instance either
        _lib.launch("flash_attention_sm90", cuda, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), 1, 16, 16, 2, 1, 192, 64, 1, 0, 0, 16, 192**-0.5)
    # the head_dim 256 instance refuses a k it cannot map for TMA (off a
    # 16-byte boundary): the launch raises, and nothing retries it elsewhere
    q, k, v = _attn_inputs(1, 16, 17, 2, 1, 256, torch.bfloat16, cuda)
    o = torch.empty_like(q)
    with pytest.raises(RuntimeError):
        _lib.launch("flash_attention_sm90", cuda, q.data_ptr(), k.data_ptr() + 2, v.data_ptr(),
                    o.data_ptr(), 1, 16, 16, 2, 1, 256, 256, 1, 0, 0, 16, 256**-0.5)


def _rwkv_inputs(B, T, H, hd, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    shp = (B, T, H, hd)
    r, k, v = (torch.randn(shp, generator=g, device=dev) * 0.3 for _ in range(3))
    w = torch.sigmoid(torch.randn(shp, generator=g, device=dev))
    u = torch.randn((H, hd), generator=g, device=dev) * 0.3
    s0 = torch.randn((B, H, hd, hd), generator=g, device=dev) * 0.1
    return r, k, v, w, u, s0


@pytest.mark.parametrize("T", [64, 1024])
def test_rwkv6_chunked_forward_is_fp32_noise_from_fp64(cuda, T):
    """ROADMAP C13: the chunked forward kernel (T > 16) sets the spread of
    rwkv6-1.6b's two-layer training parity on a card parameter draw; its y,
    like the plain sequential recurrence's on the card, is within 1e-6 of
    max|y| of the recurrence in fp64, and no further than four times the
    plain one (tests/test_torch_rwkv6_chunked.py holds the kernel's
    algorithm so on the CPU)."""
    from repro_torch.kernels.rwkv6_scan import variant_launches

    r, k, v, w, u, s0 = _rwkv_inputs(2, T, 32, 64, cuda)
    ops.reset_launches()
    got, _ = ops.rwkv6_scan(r, k, v, w, u, s0)
    assert variant_launches["chunked"] == 1
    plain, _ = R.rwkv6_scan_ref(r, k, v, w, u, s0)
    y64, _ = R.rwkv6_scan_ref(r, k, v, w, u, s0, dtype=torch.float64)
    scale = y64.abs().max().item()
    err = (got.double() - y64).abs().max().item() / scale
    err_plain = (plain.double() - y64).abs().max().item() / scale
    assert err <= 1e-6 and err_plain <= 1e-6, (err, err_plain)
    assert err <= 4 * err_plain + 1e-7, (err, err_plain)


# every gradient within 1e-4 of that input's max |g| (fp32 sums in other
# orders, the training parity's rule); extreme decays (1e-30, 1) included,
# and w = 0 exactly ("zero") at the first and last step of every sub-chunk
# and chunk of the backward kernel; T = 63, 64, 65 and 1024 at hd 64 (one
# chunk short, exact, one over, many), hd 128 beyond one chunk
@pytest.mark.parametrize("B,T,H,hd,extreme", [(2, 32, 4, 16, False), (1, 40, 2, 32, True),
                                              (3, 16, 1, 64, False), (2, 13, 2, 128, True),
                                              (8, 1, 32, 64, False), (1, 300, 4, 64, True),
                                              (2, 63, 2, 64, False), (2, 64, 2, 64, "zero"),
                                              (2, 65, 2, 64, True), (1, 1024, 4, 64, False),
                                              (1, 100, 2, 128, False), (1, 70, 2, 128, "zero"),
                                              (2, 90, 2, 32, "zero")])
def test_rwkv6_scan_backward_matches_plain(cuda, B, T, H, hd, extreme):
    ins = [t.requires_grad_(True) for t in _rwkv_inputs(B, T, H, hd, cuda)]
    if extreme == "zero":
        with torch.no_grad():
            ins[3][:, ::16] = 0.0
            ins[3][:, 15::16] = 0.0
    elif extreme:
        with torch.no_grad():
            ins[3][:, ::7] = 1e-30
            ins[3][:, 3::5, :, ::2] = 1.0
    g = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn((B, T, H, hd), generator=g, device=cuda)
    dsT = torch.randn((B, H, hd, hd), generator=g, device=cuda) * (T % 2)
    ops.reset_launches()
    y, sT = ops.rwkv6_scan(*ins)
    got = torch.autograd.grad((y, sT), ins, (dy, dsT))
    want = R.rwkv6_scan_grad_ref(*(t.detach() for t in ins), dy, dsT)
    torch.cuda.synchronize()
    assert ops.launches["rwkv6_scan"] == ops.launches["rwkv6_scan_bwd"] == 1
    for a, b in zip(want, got):
        assert torch.isfinite(b).all()
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


@pytest.mark.parametrize("B,T,H,hd", [(2, 32, 4, 16), (1, 40, 2, 32), (3, 16, 1, 64),
                                      (2, 13, 2, 128), (8, 1, 32, 64)])
def test_rwkv6_scan_matches_plain(cuda, B, T, H, hd):
    ins = _rwkv_inputs(B, T, H, hd, cuda)
    y, sT = ops.rwkv6_scan(*ins)
    yr, sTr = R.rwkv6_scan_ref(*ins)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=0, atol=3e-5)
    torch.testing.assert_close(sT, sTr, rtol=0, atol=3e-5)


def _extreme_w(w):
    """Every 7th step forgets the state (w = 1e-30); half the rows of every
    5th step keep it whole (w = 1)."""
    w = w.clone()
    w[:, ::7] = 1e-30
    w[:, 3::5, :, ::2] = 1.0
    return w


@pytest.mark.parametrize("extreme", [False, True], ids=["sigmoid_w", "extreme_w"])
@pytest.mark.parametrize("B,T,H,hd", [(2, 17, 4, 16), (1, 65, 4, 16), (3, 200, 2, 32),
                                      (2, 1000, 32, 64), (1, 129, 2, 128)])
def test_rwkv6_scan_chunked_matches_plain(cuda, B, T, H, hd, extreme):
    """T past SEQ_MAX_T runs the chunked scan: ragged last chunks, many
    chunks, and decays of exactly 1e-30 and 1."""
    from repro_torch.kernels.rwkv6_scan import variant_launches

    r, k, v, w, u, s0 = _rwkv_inputs(B, T, H, hd, cuda)
    if extreme:
        w = _extreme_w(w)
    ops.reset_launches()
    y, sT = ops.rwkv6_scan(r, k, v, w, u, s0)
    yr, sTr = R.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert variant_launches == {"seq": 0, "chunked": 1} and ops.launches["rwkv6_scan"] == 1
    torch.testing.assert_close(y, yr, rtol=0, atol=3e-5)
    torch.testing.assert_close(sT, sTr, rtol=0, atol=3e-5)


def test_rwkv6_scan_chunked_kernel_with_no_steps_keeps_the_state(cuda):
    r, k, v, w, u, s0 = _rwkv_inputs(2, 0, 2, 16, cuda)
    y, sT = torch.empty_like(r), torch.empty_like(s0)
    st = torch.empty(0, device=cuda)
    _lib.launch("rwkv6_scan_chunked", cuda, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
                st.data_ptr(), st.data_ptr(), st.data_ptr(), 2, 0, 2, 16, 64,
                count_as="rwkv6_scan")
    torch.cuda.synchronize()
    assert torch.equal(sT, s0)


def test_rwkv6_scan_seq_kernel_launched_directly_at_a_long_sequence(cuda):
    """The sequential kernel, which the wrapper keeps for decode, still
    holds at a prefill length when launched directly."""
    r, k, v, w, u, s0 = _rwkv_inputs(1, 300, 4, 64, cuda)
    w = _extreme_w(w)
    y, sT = torch.empty_like(r), torch.empty_like(s0)
    _lib.launch("rwkv6_scan", cuda, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), y.data_ptr(), sT.data_ptr(), 1, 300, 4, 64)
    yr, sTr = R.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=0, atol=3e-5)
    torch.testing.assert_close(sT, sTr, rtol=0, atol=3e-5)


def test_rwkv6_scan_chunked_takes_unaligned_views(cuda):
    """r starting one float into its storage: the wrapper copies it to an
    aligned allocation for the kernel's 16-byte staging."""
    r, k, v, w, u, s0 = _rwkv_inputs(1, 80, 2, 32, cuda)
    flat = torch.empty(r.numel() + 1, device=cuda)
    ru = flat[1:].view(r.shape)
    ru.copy_(r)
    assert ru.is_contiguous() and ru.data_ptr() % 16
    y, sT = ops.rwkv6_scan(ru, k, v, w, u, s0)
    yr, sTr = R.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=0, atol=3e-5)
    torch.testing.assert_close(sT, sTr, rtol=0, atol=3e-5)


def test_rwkv6_scan_variants_are_counted(cuda):
    from repro_torch.kernels.rwkv6_scan import variant_launches

    ops.reset_launches()
    ops.rwkv6_scan(*_rwkv_inputs(8, 1, 32, 64, cuda))  # a decode step
    ops.rwkv6_scan(*_rwkv_inputs(1, 16, 2, 16, cuda))  # SEQ_MAX_T
    ops.rwkv6_scan(*_rwkv_inputs(1, 1024, 32, 64, cuda))  # a prefill
    assert variant_launches == {"seq": 2, "chunked": 1}
    assert ops.launches["rwkv6_scan"] == 3


def test_lm_kernel_launches_are_counted(cuda):
    ops.reset_launches()
    ops.flash_attention(*_attn_inputs(1, 4, 4, 2, 1, 32, torch.float32, cuda))
    ops.rwkv6_scan(*_rwkv_inputs(1, 3, 2, 16, cuda))
    ops.rwkv6_scan(*_rwkv_inputs(1, 3, 2, 16, cuda))
    assert ops.launches["flash_attention"] == 1 and ops.launches["rwkv6_scan"] == 2


def test_lm_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _attn_inputs(1, 8, 8, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError):  # non-contiguous q
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(TypeError):  # mixed dtypes
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError):  # a dtype the kernel does not take
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # a head_dim the kernel does not take
        ops.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    r, kk, vv, w, u, s0 = _rwkv_inputs(1, 5, 2, 16, cuda)
    with pytest.raises(ValueError):  # non-contiguous r
        ops.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), kk, vv, w, u, s0)
    with pytest.raises(TypeError):  # integer inputs
        ops.rwkv6_scan(r.int(), kk, vv, w, u, s0)
    with pytest.raises(ValueError):  # mixed devices
        ops.rwkv6_scan(r, kk, vv, w.cpu(), u, s0)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-1.6b", "gemma3-12b", "llama3-8b",
                                  "nemotron-4-15b", "qwen2-moe-a2.7b", "zamba2-7b"])
def test_serve_runs_through_the_kernels(cuda, arch):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import ATTN_KINDS

    ops.reset_launches()
    res = serve(arch, num_requests=2, prompt_len=3, gen_len=4, cache_len=8)
    blocks = reduced(get_arch(arch)).blocks
    kernel, kinds = (("rwkv6_scan", ("rwkv6",)) if arch.startswith("rwkv6")
                     else ("flash_attention", ATTN_KINDS))
    assert res.tokens.shape == (2, 4) and res.logits_finite
    assert ops.launches[kernel] == sum(b.kind in kinds for b in blocks) * 7


@pytest.mark.parametrize("cf", [None, 0.25])
def test_moe_forward_on_the_card_matches_the_cpu(cuda, cf):
    """Reduced qwen2-moe-a2.7b's MoE block, fp32 (TF32 off), the same
    params and x on both devices: the same routing, so y within 1e-5 of
    max|y| and the aux losses within 1e-5 relative, with tokens dropped at
    capacity factor 0.25 and none at the config's."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import moe as M
    from repro_torch.tree import tree_map

    resolve_device(cuda)
    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    p = M.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, 8)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, waux = M.moe_forward(cfg, p, x, capacity_factor=cf)
    got, aux = M.moe_forward(cfg, tree_map(lambda t: t.to(cuda), p), x.to(cuda),
                             capacity_factor=cf)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * want.abs().max().item())
    for k in waux:
        torch.testing.assert_close(aux[k].cpu(), waux[k], rtol=1e-5, atol=0)


def test_lm_distill_on_the_card_matches_the_cpu(cuda):
    """Three steps of ``train_lm_distill.run`` on the reduced configs (fp32,
    TF32 off) on the card and on the CPU from the same params: the losses
    within 1e-5 relative at step 1 and 1e-4 after, SKR's count and head
    exact and q within 1e-6; on the card a step launches distill_loss's t
    entry once each way, SKR's fused entry once and one flash_attention
    kernel a teacher attention layer."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.examples import train_lm_distill as D
    from repro_torch.kernels.skr_rectify import variant_launches as skr
    from repro_torch.models.transformer import ATTN_KINDS, init_params
    from repro_torch.tree import tree_map

    tcfg, scfg = reduced(get_arch("llama3.2-3b")), reduced(get_arch("llama3-8b"))
    pt = init_params(tcfg, D.pair_opts(tcfg), seed=0, device="cpu")
    ps = init_params(scfg, D.pair_opts(scfg), seed=1, device="cpu")
    steps = 3
    out = []
    for d in (cuda, torch.device("cpu")):
        ops.reset_launches()
        res = D.run(tcfg, scfg, steps=steps, pt=tree_map(lambda t: t.to(d, copy=True), pt),
                    ps=tree_map(lambda t: t.to(d, copy=True), ps), device=d)
        if d == cuda:
            attn = steps * sum(b.kind in ATTN_KINDS for b in tcfg.blocks)
            assert ops.launches["distill_loss_fwd"] == ops.launches["distill_loss_bwd"] == steps
            assert skr == {"map": 0, "fused": steps}
            assert ops.launches["flash_attention"] == attn
        out.append(res)
    got, want = out
    np.testing.assert_allclose(got.losses[:1], want.losses[:1], rtol=1e-5)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    for k in ("count", "head"):
        assert torch.equal(got.skr[k].cpu(), want.skr[k])
    torch.testing.assert_close(got.skr["q"].cpu(), want.skr["q"], rtol=0, atol=1e-6)


def test_serve_decode_on_the_card(cuda):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.examples import serve_decode

    ops.reset_launches()
    res = serve_decode.main(["rwkv6-1.6b"])
    n = sum(b.kind == "rwkv6" for b in reduced(get_arch("rwkv6-1.6b")).blocks)
    assert res.tokens.shape == (serve_decode.REQUESTS, serve_decode.GEN_LEN)
    assert res.logits_finite
    assert ops.launches["rwkv6_scan"] == n * (serve_decode.PROMPT_LEN + serve_decode.GEN_LEN)


def test_host_mesh_on_nccl_gives_the_flat_mean_bit_for_bit(cuda):
    """``make_host_mesh`` on the card starts a one-rank NCCL group; the
    two-tier means over it are ``mean(0)`` bit for bit, on the (1, 1) and
    the (1, 1, 1) mesh (``edge_only_mean`` there a DTensor over "pod")."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import axis_sizes, make_host_mesh
    from repro_torch.sharding.hierarchy import edge_only_mean, hier_grad_mean

    try:
        meshes = (make_host_mesh(device=cuda), make_host_mesh(pod=1, device=cuda))
        assert dist.get_backend() == "nccl"
        g = torch.Generator(device=cuda).manual_seed(0)
        tree = {"w": torch.randn(2, 64, 48, generator=g, device=cuda).to(torch.bfloat16),
                "b": [torch.randn(2, 48, generator=g, device=cuda)]}
        flat = [tree["w"].mean(0), tree["b"][0].mean(0)]
        for mesh in meshes:
            hier = hier_grad_mean(tree, mesh)
            assert torch.equal(hier["w"], flat[0]) and torch.equal(hier["b"][0], flat[1])
            edge = edge_only_mean(tree, mesh)
            got = [edge["w"], edge["b"][0]]
            if "pod" in axis_sizes(mesh):
                assert isinstance(got[0], DTensor)
                got = [t.full_tensor()[0] for t in got]
            assert all(torch.equal(a, b) for a, b in zip(got, flat))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_laid_out_prefill_is_the_plain_step_bit_for_bit_on_one_rank(cuda):
    """A prefill step through DTensors on a one-rank NCCL mesh
    (``make_host_mesh``), with the reference's layouts (``act_spec``,
    ``moe_constrain``) as ``default_opts`` overrides, on reduced
    qwen2-moe-a2.7b in bf16 at head_dim 128 (the tensor-core kernel):
    logits bit for bit the plain step's, the same kernel launches, through
    the attention op's DTensor entry."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import sm90_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import default_opts, make_prefill_step
    from repro_torch.models.transformer import init_params
    from repro_torch.sharding import batch_specs, param_specs
    from repro_torch.sharding.specs import distribute_tree

    cfg = dataclasses.replace(reduced(get_arch("qwen2-moe-a2.7b")), head_dim=128,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    try:
        mesh = make_host_mesh(device=cuda)
        plain = default_opts(cfg)
        laid = default_opts(cfg, mesh, act_spec=("data", "model", None), moe_constrain=True)
        params = init_params(cfg, plain, seed=0, device=cuda)
        tok = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda, dtype=torch.int32)
        ops.reset_launches()
        want = make_prefill_step(cfg, plain)(params, {"tokens": tok})
        plain_n = (dict(_lib.launches), dict(sm90_launches))
        ops.reset_launches()
        got = make_prefill_step(cfg, laid)(
            distribute_tree(params, param_specs(cfg, laid, params, mesh), mesh),
            distribute_tree({"tokens": tok}, batch_specs(cfg, "prefill", 2, mesh), mesh))
        assert isinstance(got, DTensor) and torch.equal(got.to_local(), want)
        assert (dict(_lib.launches), dict(sm90_launches)) == plain_n
        assert plain_n[1][(128, 128)] == cfg.num_layers
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_dry_run_peak_matches_the_card(cuda):
    """The one-card record's traced peak of llama3.2-3b's prefill step at
    full width (4096 tokens) within 5% or 512 MiB of the card's
    ``max_memory_allocated`` over the same step."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import measure_on_card, one_card, within_bar

    cfg = get_arch("llama3.2-3b")
    rec = one_card(cfg, "prefill", 1, 4096)
    got = measure_on_card(cfg, "prefill", 1, 4096, device=cuda)
    assert rec["outputs"]["logits"][0] == list(got["out"].shape)
    assert within_bar(got["peak_bytes"], rec["memory"]["peak_bytes"]), (got, rec["memory"])
