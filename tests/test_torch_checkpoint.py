"""Checkpoint and resume of the port (``repro_torch.checkpoint``,
``SimEngine.save_checkpoint`` / ``restore_checkpoint``, the runner's flags,
``train_lm(checkpoint=)``) against the JAX package, on the CPU.

The port writes and reads the reference's msgpack format with its own
codec: its bytes are held to ``msgpack.packb(..., use_bin_type=True)``'s,
each package loads the other's files (bf16 leaves, lists and tuples
included), a resumed run is bit-identical to an uninterrupted one (as
``tests/test_faults.py`` requires of the reference: signature, eval times,
accuracy curve), and a checkpoint the JAX package wrote mid-run resumes in
the port to the JAX run's schedule (the event log without its evals, equal)
with accuracies within one test sample. The runs use the reference test's
small config (4 clients, 2 edges, 16 samples, 8x8 images, cnn2 edge and
cloud), 4 rounds, an eval every 2.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load_pytree
from repro.checkpoint import save_pytree as j_save_pytree
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs.base import FLConfig
from repro_torch.fl.engine import run_experiment


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a worker: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _small_cfg(**kw):
    base = dict(num_clients=4, num_edges=2, samples_per_client=16, test_samples=64,
                image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2")
    base.update(kw)
    return FLConfig(**base)


# ------------------------------------------------------------------ codec

CODEC_CASES = {
    "fixint": [0, 1, 127], "uint8": [128, 255], "uint16": [256, 65535],
    "uint32": [65536, 2**32 - 1], "uint64": [2**32, 2**64 - 1],
    "fixstr": ["", "a" * 31], "str8": ["a" * 32, "é" * 100], "str16": ["x" * 256],
    "str32": ["y" * 70_000], "bin8": [b"", b"\x00" * 255], "bin16": [b"\x01" * 256],
    "bin32": [b"\x02" * 70_000], "fixmap": [{}, {"a": 1, b"b": [2]}],
    "map16": [{str(i): i for i in range(16)}], "map32": [{str(i): i for i in range(70_000)}],
    "fixarray": [[], list(range(15)), (1, "a")], "array16": [list(range(16))],
    "array32": [list(range(70_000))],
}


@pytest.mark.parametrize("kind", sorted(CODEC_CASES))
def test_codec_bytes_equal_msgpacks(kind):
    for obj in CODEC_CASES[kind]:
        got = ck.packb(obj)
        assert got == msgpack.packb(obj, use_bin_type=True)
        assert ck.unpackb(got) == msgpack.unpackb(got, raw=False, strict_map_key=False)


def _tree():
    """A tree of every kind the format holds: fp32 / int / bool leaves, a
    bf16 leaf, a scalar, an empty leaf, nested lists and tuples."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "step": np.int32(7),
        "mask": rng.random(6) > 0.5,
        "bf16": bf,
        "blocks": [{"k": np.arange(5, dtype=np.int64)}, (np.zeros((0, 2), np.float32), 3)],
    }


def test_flat_map_bytes_equal_msgpacks():
    t = _tree()
    t["bf16"] = torch.from_numpy(t["bf16"]).bfloat16()
    flat = ck._flatten(t)
    assert ck.packb(flat) == msgpack.packb(flat, use_bin_type=True)
    assert flat["/bf16"][b"dtype"] == "bfloat16" and flat["/blocks/__seq__"] == "list"
    assert flat["/blocks/0001/__seq__"] == "tuple"


def _bits(x):
    """(dtype name, shape, bytes) of a numpy / JAX array or a torch tensor,
    bf16 ones included."""
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def test_port_files_load_in_the_reference_and_back(tmp_path):
    """The port writes (a bf16 torch leaf), the reference reads; the
    reference writes (an ml_dtypes bf16 leaf), the port reads; either way
    the structure (dicts, lists, tuples) and every leaf's bits come back,
    and the two files are byte for byte the same."""
    t = _tree()
    port_tree = dict(t, bf16=torch.from_numpy(t["bf16"]).bfloat16())
    jax_tree = dict(t, bf16=t["bf16"].astype(ml_dtypes.bfloat16))
    save_pytree(str(tmp_path / "port.msgpack"), port_tree)
    j_save_pytree(str(tmp_path / "jax.msgpack"), jax_tree)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()

    by_jax = j_load_pytree(str(tmp_path / "port.msgpack"))
    by_port = load_pytree(str(tmp_path / "jax.msgpack"))
    for back in (by_jax, by_port):
        assert isinstance(back["blocks"], list) and isinstance(back["blocks"][1], tuple)
        assert int(back["blocks"][1][1]) == 3
        for k in ("w", "step", "mask"):
            assert _bits(back[k]) == _bits(t[k])
        assert _bits(back["blocks"][0]["k"]) == _bits(t["blocks"][0]["k"])
        assert back["blocks"][1][0].shape == (0, 2)
        assert _bits(back["bf16"]) == _bits(jax_tree["bf16"]) == _bits(port_tree["bf16"])
    assert by_port["bf16"].dtype == torch.bfloat16


def test_empty_containers_drop_out_as_in_the_reference(tmp_path):
    """A property of the reference's format (ROADMAP C11): an empty list
    leaves only its ``__seq__`` marker and an empty dict nothing, so
    neither comes back. The port's files are the same bytes and load the
    same way; no trainer's state holds an empty container."""
    t = {"a": [], "b": (np.zeros(2),), "c": {}}
    save_pytree(str(tmp_path / "port.msgpack"), t)
    j_save_pytree(str(tmp_path / "jax.msgpack"), t)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    for back in (load_pytree(str(tmp_path / "port.msgpack")),
                 j_load_pytree(str(tmp_path / "port.msgpack"))):
        assert sorted(back) == ["b"] and isinstance(back["b"], tuple)


def test_save_pytree_midwrite_failure_keeps_old_file(tmp_path, monkeypatch):
    path = str(tmp_path / "state.msgpack")
    save_pytree(path, {"w": np.arange(4.0)})

    def exploding_replace(src, dst):
        raise OSError("simulated crash before rename")

    monkeypatch.setattr(ck.os, "replace", exploding_replace)
    with pytest.raises(OSError, match="simulated crash"):
        save_pytree(path, {"w": np.arange(8.0)})
    monkeypatch.undo()
    assert np.array_equal(load_pytree(path)["w"], np.arange(4.0))
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_engine_json_is_written_last(tmp_path, monkeypatch):
    """``engine.json`` lands after the arrays, so its presence implies a
    complete snapshot; the snapshot counts in ``sim_checkpoints_total``."""
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.scenarios import get_scenario

    cfg = _small_cfg()
    _, tree, cd, auto = build_problem(cfg, device="cpu")
    eng = SimEngine(create_algorithm("fedeec", cfg, tree, cd, auto, device="cpu"),
                    get_scenario("lossy_links"), seed=0)
    eng.run(1)
    order = []
    real = os.replace
    monkeypatch.setattr(os, "replace", lambda s, d: (order.append(os.path.basename(d)),
                                                     real(s, d)))
    d = str(tmp_path / "snap")
    eng.save_checkpoint(d)
    monkeypatch.undo()
    assert order == ["trainer.msgpack", "engine.json"]
    assert sorted(os.listdir(d)) == ["engine.json", "trainer.msgpack"]
    with open(os.path.join(d, "engine.json")) as f:
        meta = json.load(f)
    assert meta["round_next"] == 1 and meta["faults"] is not None
    assert eng.metrics.counter("sim_checkpoints_total").value == 1
    # the reference's loader reads the trainer file: params in its layout
    arrays = j_load_pytree(os.path.join(d, "trainer.msgpack"))
    assert arrays["params"]["client0"]["c1"].shape[:2] == (3, 3)  # HWIO
    assert sorted(arrays) == ["embeddings", "opt", "params", "skr"]


# ----------------------------------------------------------------- resume


@pytest.mark.parametrize("algorithm,scenario", [
    ("fedeec", "lossy_links"),
    ("hierfavg", "regional_outage"),
])
def test_checkpoint_resume_is_bit_identical(tmp_path, algorithm, scenario):
    """As the reference's ``tests/test_faults.py``: stop after 2 of 4 rounds
    with a snapshot, resume; FedEEC's dispatch is coalesced here, so the
    restore must put back every node's own AdamW step counter."""
    cfg = _small_cfg(scenario=scenario)
    full = run_experiment(algorithm, cfg, rounds=4, eval_every=2, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    run_experiment(algorithm, cfg, rounds=4, eval_every=2, stop_after=2,
                   checkpoint_every=2, checkpoint_dir=ckpt, device="cpu")
    resumed = run_experiment(algorithm, cfg, rounds=4, eval_every=2, resume_from=ckpt,
                             device="cpu")
    assert resumed.event_signature == full.event_signature
    assert resumed.sim_times == full.sim_times
    assert resumed.acc_curve == full.acc_curve
    if algorithm == "fedeec":
        assert full.dispatch_stats["batched_dispatches"] > 0


def _without_evals(entries):
    return [e for e in entries if e["kind"] != "eval"]


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """The JAX package runs ``hierfavg/regional_outage`` for 2 of 4 rounds
    and snapshots; the port resumes that snapshot (the JAX trainer's
    params, AdamW states and generator) to the end: its event log without
    evals is the uninterrupted JAX run's, and each accuracy within one test
    sample of it. The schedule does not depend on the autoencoder, which
    hierfavg never reads, so the JAX side skips its pretrain."""
    import repro.fl.engine as jengine
    from repro.configs.base import FLConfig as JConfig
    from repro.models.autoencoder import init_autoencoder

    monkeypatch.setattr(jengine, "_pretrained_auto", lambda cfg, x: init_autoencoder(
        jax.random.PRNGKey(0), image=cfg.image_size, embed_dim=cfg.embed_dim))
    kw = dict(num_clients=4, num_edges=2, samples_per_client=16, test_samples=64,
              image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2",
              scenario="regional_outage")
    jfull = jengine.run_experiment("hierfavg", JConfig(**kw), rounds=4, eval_every=2)
    ckpt = str(tmp_path / "jax_ckpt")
    jengine.run_experiment("hierfavg", JConfig(**kw), rounds=4, eval_every=2, stop_after=2,
                           checkpoint_every=2, checkpoint_dir=ckpt)
    resumed = run_experiment("hierfavg", FLConfig(**kw), rounds=4, eval_every=2,
                             resume_from=ckpt, device="cpu")
    assert _without_evals(resumed.event_log) == _without_evals(jfull.event_log)
    assert resumed.sim_times == jfull.sim_times
    assert resumed.acc_curve[0] == jfull.acc_curve[0]  # restored from the JAX log
    for a, b in zip(resumed.acc_curve, jfull.acc_curve):
        assert abs(a - b) <= 1 / 64 + 1e-12
    assert resumed.comm_bytes == jfull.comm_bytes


def test_verify_resume_on_the_cpu(capsys):
    from repro_torch.sim import runner

    argv = ["--algorithm", "hierfavg", "--scenario", "regional_outage", "--rounds", "2",
            "--clients", "4", "--edges", "2", "--samples", "16", "--test-samples", "64",
            "--image-size", "8", "--embed-dim", "16", "--verify-resume", "--device", "cpu"]
    assert runner.main(argv) == 0
    assert "(checkpoint-resume exact)" in capsys.readouterr().out


def test_runner_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.sim import runner

    base = ["--scenario", "stable", "--rounds", "2", "--clients", "4", "--edges", "2",
            "--samples", "16", "--test-samples", "64", "--image-size", "8",
            "--embed-dim", "16", "--device", "cpu", "--algorithm", "fedavg"]
    d = str(tmp_path / "ck")
    assert runner.main(base + ["--checkpoint-every", "1", "--checkpoint-dir", d]) == 0
    assert sorted(os.listdir(d)) == ["engine.json", "trainer.msgpack"]
    with open(os.path.join(d, "engine.json")) as f:
        assert json.load(f)["round_next"] == 2
    assert runner.main(base + ["--resume", d]) == 0
    assert "signature" in capsys.readouterr().out


# --------------------------------------------------------------- LM plane


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_lm_checkpoint_round_trip(tmp_path, monkeypatch, dtype):
    """``train_lm(checkpoint=)`` on a reduced llama3.2-3b of two layers:
    the file holds {"params", "opt"} in the reference's layout, and both
    packages' loaders give back what was saved bit for bit, bf16 included."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import train

    cfg = replace(reduced(get_arch("llama3.2-3b")), n_repeats=2, num_layers=2,
                  param_dtype=dtype, compute_dtype=dtype)
    saved = {}
    real = train.save_pytree
    monkeypatch.setattr(train, "save_pytree",
                        lambda p, tree: (saved.update(tree=tree), real(p, tree)))
    path = str(tmp_path / "lm.msgpack")
    train.train_lm(cfg, steps=2, batch=1, seq=8, checkpoint=path, device="cpu")
    tree = saved["tree"]
    assert sorted(tree) == ["opt", "params"] and sorted(tree["opt"]) == ["m", "step", "v"]
    assert int(tree["opt"]["step"]) == 2
    want = jax.tree.leaves(tree)
    assert any(np.asarray(a).dtype.name == dtype for a in want)
    for back in (load_pytree(path), j_load_pytree(path)):
        got = jax.tree.leaves(back)
        assert [_bits(b) for b in got] == [_bits(a) for a in want]
    assert jnp.asarray(j_load_pytree(path)["params"]["embed"]).dtype == jnp.dtype(dtype)
