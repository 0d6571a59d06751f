"""The dry run's DTensor trace: a step laid out over a mesh of a fake
process group (``launch.mesh.make_fake_mesh``), traced on ``meta`` shards
(``launch.dryrun.trace_on_mesh``), in a child process (a fake group never
shares a process with a real one).

* On a 1x1 mesh the trace of each mode (prefill, decode at a full cache,
  one training step with the loss on distill_loss's CE entry) equals
  ``one_card``'s trace of the same step, byte for byte (argument, output,
  temp, peak) and FLOP for FLOP, for reduced configs of a dense GQA
  (llama3.2-3b), an MoE (qwen2-moe-a2.7b), an MLA (deepseek-v2-lite-16b at
  its full MLA dims, which the latent decode kernel takes) and an RWKV6
  (rwkv6-1.6b) family, with no collective.
* On a (2, 4) mesh, with DTensor's strided shards refused (torch 2.11
  refuses a fold whose inner dimension is sharded, where 2.13 strides it),
  with and without the layouts: the local shards of the laid-out arguments hold
  ``per_device_bytes`` of the trees; each kernel's FLOPs are the 1x1
  trace's divided by the 8 shards it sees (batch over "data", heads or
  rows over "model"), with the layouts as without; no kernel op returns a plain tensor for DTensor
  inputs; the collectives of one dense block's prefill are the ones
  counted by hand below.
* The production meshes: ``run_one`` of whisper-small ``prefill_32k`` on
  16x16 and rwkv6-1.6b ``long_500k`` on 2x16x16 (the pairs the
  reference's own test compiles) gives ``temp_bytes > 0``, a non-empty
  ``collectives`` and the argument bytes that the spec rules reckoned
  before the trace existed."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["llama3.2-3b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "rwkv6-1.6b"]
MODES = ["prefill", "decode", "train"]

CHILD = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MeshSpec, make_fake_mesh
from repro_torch.launch.steps import default_opts
from repro_torch.sharding import batch_specs, cache_specs, param_specs, zero1_specs
from repro_torch.sharding.specs import per_device_bytes
from repro_torch.tree import tree_leaves

B, S = 8, 64
plain = []


def watch(name):
    fn = getattr(ops, name)

    def wrapped(*a, **kw):
        got = fn(*a, **kw)
        if any(isinstance(t, DTensor) for t in a):
            outs = got if isinstance(got, tuple) else (got,)
            plain.extend(name for t in outs if not isinstance(t, DTensor))
        return got
    setattr(ops, name, wrapped)


for name in ("flash_attention", "latent_decode", "rwkv6_scan", "fused_softmax_xent"):
    watch(name)


def config(arch):
    cfg = reduced(get_arch(arch))
    if arch == "deepseek-v2-lite-16b":
        full = get_arch(arch)
        cfg = dataclasses.replace(cfg, kv_lora_rank=full.kv_lora_rank,
                                  qk_rope_dim=full.qk_rope_dim, qk_nope_dim=full.qk_nope_dim,
                                  v_head_dim=full.v_head_dim)
    return cfg


def opts_of(cfg, mode, mesh):
    return default_opts(cfg, mesh, use_kernels=mode == "train")


def kernels(traced):
    return {k: v["flops"] for k, v in traced["cost"]["kernels"].items()}


out = {"one": {}, "mesh": {}}
mesh = make_fake_mesh(MeshSpec(("data", "model"), (1, 1)))
for arch in sys.argv[2].split(","):
    cfg = config(arch)
    for mode in sys.argv[3].split(","):
        o = opts_of(cfg, mode, mesh)
        traced = D.trace_on_mesh(cfg, o, mode, B, S, mesh)
        card = D.one_card(cfg, mode, B, S, opts=o)
        out["one"][f"{arch} {mode}"] = dict(
            mesh=traced["memory"], card=card["memory"], mesh_flops=traced["cost"]["flops"],
            card_flops=card["cost"]["flops"], collectives=traced["collectives"],
            kernels=kernels(traced))
dist.destroy_process_group()
# torch 2.11's DTensor refuses a fold of dimensions whose inner one is
# sharded, where 2.13 makes a strided shard: refuse it here too, so that
# the (2, 4) traces hold the model to the stricter rule
import torch.distributed.tensor.placement_types as placement_types


def refuse(self, *a, **kw):
    raise RuntimeError("a fold with a sharded inner dimension (a strided shard)")


placement_types._StridedShard.__init__ = refuse
mesh = make_fake_mesh(MeshSpec(("data", "model"), (2, 4)))
for arch in sys.argv[2].split(","):
    cfg = config(arch)
    for mode in sys.argv[3].split(","):
        o = opts_of(cfg, mode, mesh)
        step, args = D.mesh_step_inputs(cfg, o, mode, B, S, mesh)
        local = sum(t.to_local().numel() * t.element_size() for t in tree_leaves(args)
                    if isinstance(t, DTensor))
        _, meta_args = D.step_inputs(cfg, o, mode, B, S)
        params = meta_args[0]
        pspec = param_specs(cfg, o, params, mesh)
        specs = [pspec]
        if mode == "train":
            m = zero1_specs(pspec, params, mesh)
            specs.append({"step": (), "m": m, "v": m})
        elif mode == "decode":
            specs.append(cache_specs(cfg, o, meta_args[1], mesh, batch=B, seq=S))
        specs.append(batch_specs(cfg, mode, B, mesh))
        reckoned = sum(per_device_bytes(t, s, mesh) for t, s in zip(meta_args, specs))
        traced = D.trace_step(step, args)
        laid = D.trace_on_mesh(cfg, dataclasses.replace(
            default_opts(cfg, mesh, seq_parallel=True, moe_constrain=True),
            use_kernels=mode == "train"), mode, B, S, mesh)
        out["mesh"][f"{arch} {mode}"] = dict(local=local, reckoned=reckoned,
                                             kernels=kernels(traced),
                                             collectives=traced["collectives"],
                                             laid_kernels=kernels(laid),
                                             laid_collectives=laid["collectives"])
# one dense block's prefill, its collectives one by one
seen = []
orig = D.LiveBytes.__torch_dispatch__


def listed(self, func, types, args=(), kwargs=None):
    before = {k: dict(v) for k, v in self.collectives.items()}
    got = orig(self, func, types, args, kwargs)
    for k, v in self.collectives.items():
        if v != before.get(k):
            seen.append([k, v["bytes"] - before.get(k, {"bytes": 0})["bytes"]])
    return got


D.LiveBytes.__torch_dispatch__ = listed
cfg = reduced(get_arch("llama3.2-3b"))
D.trace_on_mesh(cfg, default_opts(cfg, mesh), "prefill", B, S, mesh)
out["dense_prefill"] = seen
out["plain"] = plain
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    path = tmp_path_factory.mktemp("dtensor") / "out.json"
    proc = subprocess.run([sys.executable, "-c", CHILD, str(path), ",".join(ARCHS),
                           ",".join(MODES)], env=_env(), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-8000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_one_by_one_mesh_traces_as_one_card(traced, arch, mode):
    rec = traced["one"][f"{arch} {mode}"]
    assert rec["mesh"] == rec["card"]
    assert rec["mesh_flops"] == rec["card_flops"] > 0
    assert rec["collectives"] == {}
    assert rec["kernels"]  # every mode of these families reaches a kernel


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_two_by_four_mesh_shards_the_arguments_and_the_kernels(traced, arch, mode):
    rec = traced["mesh"][f"{arch} {mode}"]
    assert rec["local"] == rec["reckoned"] > 0
    one = traced["one"][f"{arch} {mode}"]["kernels"]
    assert set(rec["kernels"]) == set(one)
    for name, flops in one.items():
        # batch 8 over the 2-way data axis; 4 heads (KV heads replicated
        # to 4) or the loss's rows over the 4-way model axis
        assert rec["kernels"][name] == pytest.approx(flops / 8, rel=1e-12), name
    # with act_spec and moe_constrain the kernels see the same shards
    assert rec["laid_kernels"] == rec["kernels"]
    assert rec["collectives"] and rec["laid_collectives"]


def test_no_kernel_op_returns_a_plain_tensor_for_dtensor_inputs(traced):
    assert traced["plain"] == []


# Reduced llama3.2-3b (one attn block, d 128, 4 heads of 32, KV heads
# replicated to 4, ff 256, vocab 512, fp32) prefill of 8 x 64 tokens on the
# (2, 4) mesh: a device holds 4 sequences (batch over "data"), a quarter of
# the vocabulary, of the heads and of the MLP's width ("model"). The
# vocab-parallel embedding and each row-parallel product (wo, down) leave
# the stream a partial sum over "model", which the next norm sums, once;
# the norm's output is whole, so the column-parallel products (wq, wk, wv,
# gate, up) need nothing and give the attention its heads in place, and
# the last position's logits come out vocab-sharded: one all-reduce of the
# (4, 64, 128) fp32 stream for each of ln1, ln2 and final_norm, as tensor
# parallelism does.
DENSE_PREFILL = [["all-reduce", 4 * 64 * 128 * 4]] * 3


def test_one_dense_blocks_prefill_collectives_by_hand(traced):
    assert traced["dense_prefill"] == DENSE_PREFILL


# the production records' argument bytes as the spec rules reckoned them
# before the production meshes were traced (python -m repro_torch.launch.dryrun)
PRODUCTION = [("whisper-small", "prefill_32k", False, 87_648_256),
              ("rwkv6-1.6b", "long_500k", True, 301_768_712)]


@pytest.mark.parametrize("arch,shape,multi_pod,argument", PRODUCTION)
def test_production_mesh_records(arch, shape, multi_pod, argument, tmp_path):
    rec = D.run_one(arch, shape, multi_pod=multi_pod, out_dir=str(tmp_path))
    mesh = "2x16x16" if multi_pod else "16x16"
    assert rec["status"] == "ok" and rec["mesh"] == mesh
    assert rec["num_devices"] == (512 if multi_pod else 256)
    m = rec["memory"]
    assert isinstance(m["temp_bytes"], int) and m["temp_bytes"] > 0
    assert m["argument_bytes"] == argument
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert rec["collectives"] and all(v["count"] > 0 and v["bytes"] > 0
                                      for v in rec["collectives"].values())
    assert rec["collectives_counted"] == "whole_step" and rec["cost"]["flops"] > 0
    assert (tmp_path / f"{arch}__{shape}__{mesh}.json").exists()
    assert "[OK]" in D.record_line(rec) and "all-" in D.record_line(rec)
