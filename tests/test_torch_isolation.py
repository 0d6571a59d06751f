"""The port stands alone: no JAX, nothing of ``repro``, and neither msgpack
nor ml_dtypes (the card's machine has neither) in its package or in
``chip_smoke.py``; its entry points run on the card unless the caller asks
for the CPU."""
import ast
import json
import os
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro_torch.configs.base import FLConfig

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a worker: the suite's workers share the cores,
    and one thread per core each oversubscribes them (the CPU FedEEC run
    below took over ten minutes in a full parallel run without this)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"fedeec.py", "engine.py", "distill_loss.py", "chip_smoke.py",
            "flash_attention.py", "rwkv6_scan.py", "serve.py", "transformer.py",
            "train.py", "steps.py", "loader.py", "schedule.py", "optimizers.py",
            "events.py", "churn.py", "faults.py", "scenarios.py", "network.py",
            "runner.py", "metrics.py", "quickstart.py", "scenario_sweep.py", "tree.py",
            "baselines.py", "checkpoint.py", "protocols.py", "fedeec_vs_baselines.py",
            "custom_algorithm.py", "dynamic_migration.py"} <= names
    sim = {p.name for p in PORT_FILES if p.parent.name == "sim"}
    assert {"engine.py", "events.py", "churn.py", "faults.py", "scenarios.py",
            "network.py", "runner.py"} <= sim


def _no_card():
    return mock.patch.object(torch.cuda, "is_available", return_value=False)


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    from repro_torch.core.fedeec import FedEEC
    from repro_torch.core.topology import Tree
    from repro_torch.fl.baselines import FlatFedAvg, HierarchicalFedAvg
    from repro_torch.fl.engine import build_problem, run_experiment

    cfg = FLConfig(num_clients=2, num_edges=1, samples_per_client=4, test_samples=8,
                   image_size=8, embed_dim=16)
    with _no_card():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_experiment("fedeec", cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_experiment("fedeec", cfg, scenario="stable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_problem(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FedEEC(cfg, Tree.three_tier(1, 2), {}, {})
        for alg in ("hierfavg", "fedavg"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                run_experiment(alg, cfg, scenario="stable", resume_from="unused")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HierarchicalFedAvg(cfg, Tree.three_tier(1, 2), {})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FlatFedAvg(cfg, {})


def test_lm_entry_points_default_to_cuda_and_raise_without_a_card():
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import (
        ModelOpts, forward_decode, init_cache, init_params)

    cfg, opts = reduced(get_arch("rwkv6-1.6b")), ModelOpts()
    params = init_params(cfg, opts, device="cpu")
    with _no_card():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve("rwkv6-1.6b", num_requests=1, prompt_len=1, gen_len=1, cache_len=4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(cfg, opts)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_cache(cfg, opts, 1, 4)
        # a decode whose cache is made on the default device stops there,
        # before any model code runs on the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            forward_decode(cfg, opts, params, {"token": torch.zeros((1, 1), dtype=torch.long),
                                               "pos": 0}, init_cache(cfg, opts, 1, 4))


def test_train_lm_defaults_to_cuda_and_raises_without_a_card():
    from repro_torch.launch import train

    with _no_card():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.train_lm("llama3.2-3b", steps=1, batch=1, seq=4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--steps", "1", "--batch", "1", "--seq", "4"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--fl", "--rounds", "1"])


def _on_the_card():
    """Every tensor claims to lie on a card, so a wrapper takes its CUDA
    path (which, here, stops before anything reaches the card)."""
    return mock.patch.object(torch.Tensor, "is_cuda", new=property(lambda self: True))


def _attn(requires_grad):
    q, k, v = (torch.zeros(s, requires_grad=requires_grad)
               for s in ((1, 4, 2, 32), (1, 4, 1, 32), (1, 4, 1, 32)))
    return q, k, v


def _scan(requires_grad):
    B, T, H, hd = 1, 3, 2, 16
    ins = [torch.zeros((B, T, H, hd)) for _ in range(4)]
    ins += [torch.zeros((H, hd)), torch.zeros((B, H, hd, hd))]
    ins[0].requires_grad_(requires_grad)
    return ins


@pytest.mark.parametrize("kernel", ["flash_attention"])
def test_forward_only_kernels_refuse_inputs_that_require_grad(kernel):
    """The flash_attention kernels have no backward: on a card the wrapper
    raises when grad mode is on and an input requires grad, instead of
    returning an output with no grad_fn (a gradient dropped without a
    word). Under no_grad, or with no such input, the guard lets the call
    through (here it then stops at the kernel build)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import flash_attention

    fn, make = (lambda a: flash_attention(*a)), _attn
    with _on_the_card():
        with pytest.raises(RuntimeError, match="no backward"):
            fn(make(True))
        for ins, ctx in ((make(True), torch.no_grad()), (make(False), torch.enable_grad())):
            with ctx, mock.patch.object(_lib, "launch", side_effect=RuntimeError("launched")):
                with pytest.raises(RuntimeError, match="launched"):
                    fn(ins)
    # on the CPU the plain version runs under autograd
    assert fn(make(True)).grad_fn is not None


def test_rwkv6_scan_on_the_card_records_a_grad_fn_and_launches_its_backward():
    """On a card, a call with an input that requires grad goes through
    ``Rwkv6Scan``: the forward launches the kernel ``_variant`` picks and
    the output records a grad_fn, whose backward launches
    ``rwkv6_scan_bwd`` once, on every input's gradient buffers, with no
    plain version run on either side. Under no_grad the call launches the
    forward alone and records nothing (the serving path)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    names = []
    fake = lambda name, *a, **kw: names.append(name)  # noqa: E731
    with _on_the_card(), mock.patch.object(_lib, "launch", side_effect=fake), \
            mock.patch.object(R, "rwkv6_scan_ref", side_effect=AssertionError("plain")), \
            mock.patch.object(R, "rwkv6_scan_grad_ref", side_effect=AssertionError("plain")):
        with torch.no_grad():
            y, sT = rwkv6_scan(*_scan(True))
        assert y.grad_fn is None and names == ["rwkv6_scan"]
        names.clear()
        ins = _scan(True)
        y, sT = rwkv6_scan(*ins)
        assert type(y.grad_fn).__name__ == "Rwkv6ScanBackward"
        assert names == ["rwkv6_scan"]
        (g,) = torch.autograd.grad(y.sum() + sT.sum(), [ins[0]])
        assert names == ["rwkv6_scan", "rwkv6_scan_bwd"] and g.shape == ins[0].shape


def test_examples_default_to_cuda_and_raise_without_a_card():
    from repro_torch.examples import (
        custom_algorithm,
        dynamic_migration,
        fedeec_vs_baselines,
        quickstart,
        scenario_sweep,
        serve_decode,
        train_lm_distill,
    )

    with _no_card():
        for example in (quickstart, scenario_sweep, fedeec_vs_baselines, custom_algorithm,
                        dynamic_migration, train_lm_distill, serve_decode):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                example.main([])


def test_batched_entries_launch_on_the_card_or_raise():
    """The (B, N, V) entries a coalesced group runs through take their CUDA
    path on a card's tensors, with no fallback to the plain versions (here
    the path stops at the launch)."""
    from repro_torch.kernels import _lib, ops

    B, N, C = 2, 4, 10
    z, t = torch.zeros((B, N, C)), torch.full((B, N, C), -2.0)
    y = torch.zeros((B, N), dtype=torch.long)
    q, cnt = torch.zeros((B, C, 3)), torch.zeros((B, C), dtype=torch.int32)
    calls = [lambda: ops.fused_distill_loss_batched(z, t, y, beta=1.0),
             lambda: ops.fused_softmax_xent_batched(z, y),
             lambda: ops.skr_process_batched(torch.softmax(z, -1), y, q, cnt, cnt.clone())]
    with _on_the_card(), mock.patch.object(_lib, "launch",
                                           side_effect=RuntimeError("launched")), \
            mock.patch.object(_lib, "check_faults"), \
            mock.patch.object(_lib, "fault_words", return_value=torch.zeros(64)):
        for call in calls:
            with pytest.raises(RuntimeError, match="launched"):
                call()


def test_decode_profiler_needs_a_card():
    from repro_torch.launch import profile_serve

    with _no_card():
        with pytest.raises(SystemExit, match="no CUDA device"):
            profile_serve.main([])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profile_serve.profile_decode("rwkv6-1.6b")


@pytest.mark.parametrize("kind", ["mamba", "retnet"])
def test_unported_block_kinds_raise(kind):
    """A block kind the reference does not know either: the port raises
    ValueError naming it, as the reference's ``init_block`` does, from
    ``init_block`` and, for a model with such a block, ``init_params``."""
    from dataclasses import replace

    from repro_torch.configs import BlockKind, get_arch, reduced
    from repro_torch.models.transformer import ModelOpts, init_block, init_params

    cfg = reduced(get_arch("llama3.2-3b"))
    with pytest.raises(ValueError, match=repr(kind)):
        init_block(torch.Generator(), cfg, kind, ModelOpts())
    cfg = replace(cfg, pattern=(BlockKind(kind),))
    with pytest.raises(ValueError, match=repr(kind)):
        init_params(cfg, ModelOpts(), device="cpu")


@pytest.mark.parametrize("kind", ["local_attn", "moe", "mla", "mla_moe", "mamba2",
                                  "shared_attn"])
def test_ported_block_kinds_initialise_and_run(kind):
    """The kinds that raised before they were ported: a model of that kind
    alone initialises, prefills and decodes on the CPU, and a block of it
    has the reference's parameter keys. A shared block has one parameter
    copy (``params["shared"]``) and a cache slot for each occurrence."""
    from dataclasses import replace

    from repro_torch.configs import BlockKind, get_arch, reduced
    from repro_torch.models.transformer import (
        ModelOpts,
        forward_decode,
        forward_prefill,
        init_block,
        init_cache,
        init_params,
    )

    arch = {"moe": "qwen2-moe-a2.7b", "mla": "deepseek-v2-lite-16b",
            "mla_moe": "deepseek-v2-lite-16b", "mamba2": "zamba2-7b",
            "shared_attn": "zamba2-7b"}.get(kind, "gemma3-12b")
    base = reduced(get_arch(arch))
    block = init_block(torch.Generator(), base, kind, ModelOpts())
    attn = "mla" if kind.startswith("mla") else "attn"
    if kind == "mamba2":
        assert set(block) == {"ln1", "mamba"}
    else:
        assert set(block) == {"ln1", attn, "ln2", "moe" if kind.endswith("moe") else "mlp"}
    shared = kind == "shared_attn"
    cfg = replace(base, head_blocks=(), tail_blocks=(), pattern=(BlockKind(kind, shared),),
                  n_repeats=2, num_layers=2)
    params = init_params(cfg, ModelOpts(), device="cpu")
    assert set(params["shared"]) == ({kind} if shared else set())
    assert set(params["unit"]) == (set() if shared else {"blk0"})
    tok = torch.ones((2, 3), dtype=torch.long)
    logits = forward_prefill(cfg, ModelOpts(), params, {"tokens": tok})
    cache = init_cache(cfg, ModelOpts(), 2, 4, torch.float32, device="cpu")
    step, _ = forward_decode(cfg, ModelOpts(), params, {"token": tok[:, :1], "pos": 0}, cache)
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    shapes = {k: tuple(t.shape) for k, t in cache["unit"]["blk0"].items()}
    if attn == "mla":
        assert shapes == {"c_kv": (2, 2, 4, cfg.kv_lora_rank),
                          "k_rope": (2, 2, 4, cfg.qk_rope_dim)}
    elif kind == "mamba2":
        W = cfg.conv_width
        assert shapes == {"conv_x": (2, 2, W - 1, cfg.d_inner),
                          "conv_BC": (2, 2, W - 1, 2 * cfg.ssm_state),
                          "s": (2, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)}
    else:
        assert shapes["k"] == (2, 2, 4, cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("change", [dict(enc_dec=True, enc_layers=1, enc_seq_len=8),
                                    dict(frontend="vision_stub", num_media_tokens=4),
                                    dict(learned_pos_emb=True)])
def test_model_features_initialise_and_run(change):
    """The model features that raised until the port ran them (an
    encoder-decoder model, the vision frontend's media prefix, learned
    position embeddings) initialise, prefill and decode on a reduced
    llama3.2-3b."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import (
        ModelOpts,
        forward_decode,
        forward_prefill,
        init_cache,
        init_params,
    )

    cfg = replace(reduced(get_arch("llama3.2-3b")), **change)
    params = init_params(cfg, ModelOpts(), device="cpu")
    assert ("encoder" in params) == cfg.enc_dec and ("pos_embed" in params) == \
        cfg.learned_pos_emb
    batch = {"tokens": torch.ones((2, 3), dtype=torch.long)}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((2, cfg.enc_seq_len, cfg.d_model))
    if cfg.frontend == "vision_stub":
        batch["media"] = torch.randn((2, cfg.num_media_tokens, cfg.d_model))
    logits = forward_prefill(cfg, ModelOpts(), params, batch)
    cache = init_cache(cfg, ModelOpts(), 2, 4, torch.float32, device="cpu")
    step, _ = forward_decode(cfg, ModelOpts(), params,
                             {"token": batch["tokens"][:, :1], "pos": 0}, cache)
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()


def test_unknown_frontend_raises():
    """A frontend name the reference does not know raises."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import ModelOpts, init_params

    cfg = replace(reduced(get_arch("llama3.2-3b")), frontend="video_stub")
    with pytest.raises(ValueError, match="frontend"):
        init_params(cfg, ModelOpts(), device="cpu")


def test_unported_options_raise(tmp_path):
    """Tracing runs on the plain path and the scenario path alike, and the
    runner's ``--trace`` / ``--explain-rounds`` exit 0 and write the trace
    and the attribution. The checkpoint options run (A4): on the scenario
    path a snapshot is written and resumed; the plain path ignores them, as
    the reference's does."""
    from repro_torch.fl.engine import run_experiment
    from repro_torch.obs.trace import Tracer
    from repro_torch.sim import runner

    cfg = FLConfig(num_clients=2, num_edges=1, samples_per_client=4, test_samples=8,
                   image_size=8, embed_dim=16, end_model="cnn2", edge_model="cnn2",
                   cloud_model="cnn2", distill_steps=1)
    for scenario in (None, "stable"):
        tr = Tracer()
        run_experiment("fedeec", cfg, device="cpu", scenario=scenario, tracer=tr,
                       rounds=1)
        cats = {sp.cat for sp in tr.spans}
        assert {"execute", "kernel"} <= cats
        assert ("round" in cats) == (scenario is not None)
    ckpt = str(tmp_path / "ck")
    for scenario in (None, "stable"):
        res = run_experiment("hierfavg", cfg, rounds=2, device="cpu", scenario=scenario,
                             checkpoint_every=1, checkpoint_dir=ckpt)
        assert len(res.acc_curve) == 2
        assert os.path.isdir(ckpt) == (scenario is not None)
    resumed = run_experiment("hierfavg", cfg, rounds=2, device="cpu", scenario="stable",
                             resume_from=ckpt)
    assert resumed.event_signature == res.event_signature
    trace = tmp_path / "t.json"
    argv = ["--scenario", "stable", "--algorithm", "hierfavg", "--rounds", "1",
            "--clients", "2", "--edges", "1", "--samples", "4", "--test-samples", "8",
            "--image-size", "8", "--embed-dim", "16", "--device", "cpu"]
    assert runner.main(argv + ["--trace", str(trace), "--explain-rounds"]) == 0
    doc = json.loads(trace.read_text())
    assert {e.get("cat") for e in doc["traceEvents"]} >= {"round", "item"}
    out = tmp_path / "log.json"
    assert runner.main(argv + ["--explain-rounds", "--out", str(out)]) == 0
    from repro_torch.obs.critical_path import explain, rounds_from_eventlog

    text = explain(rounds_from_eventlog(json.loads(out.read_text())))
    assert text.startswith("== round 0 ==") and "gated by: node" in text


def test_registry_has_the_slice_algorithms():
    from repro_torch.fl.api import list_algorithms

    assert list_algorithms() == ["demlearn", "fedagg", "fedavg", "fedeec", "hierfavg",
                                 "hiermo", "hierqsgd"]


def test_fedeec_runs_on_cpu_when_asked():
    from repro_torch.fl.engine import run_experiment

    # two edges of one client each; the migration demo moves client0 to
    # edge1 before the first round, leaving edge0 with an empty store
    cfg = FLConfig(num_clients=2, num_edges=2, samples_per_client=8, test_samples=16,
                   image_size=8, embed_dim=16, distill_steps=1)
    res = run_experiment("fedeec", cfg, rounds=2, device="cpu", migration_round=0)
    assert len(res.acc_curve) == 2 and all(0.0 <= a <= 1.0 for a in res.acc_curve)
    assert res.comm_bytes["end-edge"] > 0 and len(res.round_s) == 2
