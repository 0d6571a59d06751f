"""Every kept (architecture, input shape) pair of the dry run traced on
both production meshes (16x16 and 2x16x16, a fake process group of 256 or
512 ranks), as ``python -m repro_torch.launch.dryrun --all --both-meshes``
traces them, with the reference's two levers (``--seq-parallel
--moe-constrain``) besides on the MoE families' ``train_4k``.

Each model is cut to one repeat of its pattern at full width (an encoder to
one layer): the repeats run the same ops again, so one repeat meets every
sharding rule, redistribution and kernel entry that the full depth meets,
in a few seconds a record. The records are traced in five child
processes at once, one for 16x16 and four for 2x16x16 (whose traces take
about four times as long), with DTensor's strided shards refused (torch
2.11 refuses a fold whose inner dimension is sharded, where 2.13 strides
it), so that a pair that traces here traces under either.
Each record is held to what a production record promises: status ok, an
integer ``temp_bytes`` > 0, ``peak_bytes`` = argument + temp, a collectives
dict with calls and bytes, and FLOPs."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs, load_all
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"16x16": False, "2x16x16": True}
CHILDREN = {"16x16": 1, "2x16x16": 4}  # child processes a mesh
LEVERS = [("qwen2-moe-a2.7b", "train_4k"), ("deepseek-v2-lite-16b", "train_4k")]


def _kept():
    load_all()
    return [(a, s) for a in list_archs() for s in INPUT_SHAPES
            if D.shape_skip_reason(get_arch(a), s, False) is None]


KEPT = _kept()
JOBS = [(a, s, False) for a, s in KEPT] + [(a, s, True) for a, s in LEVERS]

CHILD = r"""
import dataclasses, json, sys
from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.launch.steps import default_opts
import torch.distributed.tensor.placement_types as placement_types


def refuse(self, *a, **kw):
    raise RuntimeError("a fold with a sharded inner dimension (a strided shard)")


placement_types._StridedShard.__init__ = refuse
multi_pod = sys.argv[2] == "1"
mesh = make_fake_mesh(make_production_mesh(multi_pod=multi_pod))
out = {}
for arch, shape, levers in json.loads(sys.argv[3]):
    rec, cfg = D.record_head(arch, shape, multi_pod=multi_pod, seq_parallel=levers,
                             moe_constrain=levers)
    cfg = dataclasses.replace(
        cfg, n_repeats=1, num_layers=cfg.num_layers - len(cfg.pattern) * (cfg.n_repeats - 1),
        enc_layers=min(cfg.enc_layers, 1))
    opts = default_opts(cfg, mesh, seq_parallel=levers, moe_constrain=levers)
    try:
        rec.update(D.sharded(cfg, opts, INPUT_SHAPES[shape], mesh))
        rec.pop("outputs")
    except Exception as e:  # every failure is the test's to report
        rec = {"error": f"{type(e).__name__}: {e}"}
    out[f"{arch} {shape} {levers}"] = rec
with open(sys.argv[1], "w") as f:
    json.dump(out, f, default=float)
"""


def _deal(jobs, n):
    """``jobs`` dealt to ``n`` children, the training records first, each
    to the least loaded child (a training trace takes about five times as
    long as another)."""
    load, out = [0] * n, [[] for _ in range(n)]
    for job in sorted(jobs, key=lambda j: j[1] != "train_4k"):
        i = load.index(min(load))
        out[i].append(job)
        load[i] += 5 if job[1] == "train_4k" else 1
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("production")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = []
    for mesh, multi_pod in MESHES.items():
        for i, jobs in enumerate(_deal(JOBS, CHILDREN[mesh])):
            path = tmp / f"{mesh}-{i}.json"
            procs.append((mesh, path, subprocess.Popen(
                [sys.executable, "-c", CHILD, str(path), str(int(multi_pod)), json.dumps(jobs)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {mesh: {} for mesh in MESHES}
    for mesh, path, proc in procs:
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-8000:]
        out[mesh].update(json.loads(path.read_text()))
    return out


def test_every_kept_pair_is_traced():
    # the dry run's sweep keeps 34 of the 40 pairs (long_500k is skipped
    # for the pure full-attention and the enc-dec families)
    assert len(KEPT) == 34 and len(set(KEPT)) == 34


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape,levers", JOBS,
                         ids=[f"{a}-{s}{'-levers' if lv else ''}" for a, s, lv in JOBS])
def test_kept_pair_traces_on_the_production_mesh(records, mesh, arch, shape, levers):
    rec = records[mesh][f"{arch} {shape} {levers}"]
    assert "error" not in rec, rec.get("error")
    assert rec["status"] == "ok" and rec["mesh"] == mesh
    assert rec["num_devices"] == (512 if MESHES[mesh] else 256)
    assert (rec["seq_parallel"], rec["moe_constrain"]) == (levers, levers)
    m = rec["memory"]
    assert isinstance(m["temp_bytes"], int) and m["temp_bytes"] > 0
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert rec["collectives"] and all(v["count"] > 0 and v["bytes"] > 0
                                      for v in rec["collectives"].values())
    assert rec["collectives_counted"] == "whole_step" and rec["cost"]["flops"] > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_constrain_holds_the_experts_shard_of_the_dispatch_buffer(records, mesh):
    # qwen2-moe-a2.7b's train_4k at one repeat: without the levers DTensor
    # gathers the whole (E, cap, d) buffer onto every device; with them each
    # device holds its E / 16 experts' slots (models.moe._expert_parallel)
    plain = records[mesh]["qwen2-moe-a2.7b train_4k False"]["memory"]["temp_bytes"]
    laid = records[mesh]["qwen2-moe-a2.7b train_4k True"]["memory"]["temp_bytes"]
    assert laid < plain / 4
