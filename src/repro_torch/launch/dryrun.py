"""Dry run: every (architecture x input shape x mesh) combination sized
without allocating a byte of it.

Counterpart of ``repro.launch.dryrun``. For each combination it runs the
real step of ``launch.steps`` on ``meta`` inputs under ``trace_step``: a
``TorchDispatchMode`` that keeps the bytes of every live storage (each
op's new outputs added, each storage's release taken off by a weakref
finalizer, sizes rounded up to the caching allocator's 512 bytes), with
the kernels' scratch, which their wrappers allocate on ``meta`` as on the
card; ``FlopCounterMode`` for the torch ops, plus the FLOPs each kernel
declares through ``kernels._lib.meta_launch``; and the functional
collectives that DTensor runs, by the reference's kinds.

* on a production mesh (``16x16``, ``2x16x16``) the inputs are laid out by
  the spec rules (``repro_torch.sharding``) as DTensors of ``meta`` shards
  on a ``DeviceMesh`` of the mesh's shape over a fake process group
  (``launch.mesh.make_fake_mesh``: one rank real, every other imagined,
  no collective run), the port's counterpart of the reference's compile
  over 512 host devices. Every mode sees the ops DTensor runs on this
  rank's shards, so the record is one device's: ``memory``
  (``argument_bytes`` reckoned from the specs as XLA's
  ``argument_size_in_bytes`` counts them, ``temp_bytes`` the traced peak
  over the traced arguments, ``peak_bytes``, ``output_bytes``), ``cost``
  (FLOPs) and ``collectives`` (kind -> calls and result bytes). The port
  loops over the repeats in Python, so the collectives are the whole
  step's (``collectives_counted: "whole_step"``), where the reference's
  ``parse_collectives`` counts a scanned body once. A fake group never
  shares a process with a real one: the records of a mesh are traced in
  one child process (``run_records``);
* on one card (``card=True``, mesh ``1x1``) the step runs on plain ``meta``
  tensors. Its record holds ``memory`` (``argument_bytes``,
  ``output_bytes``, ``temp_bytes`` = the peak over the arguments,
  ``peak_bytes``), ``cost`` and ``fits_one_card`` (the peak at least
  ``HEADROOM`` under the card's memory).

Records go to ``<out_dir>/<arch>__<shape>__<mesh>[__<tag>].json``, as the
reference's file names.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all                  # every pair, 16x16
  python -m repro_torch.launch.dryrun --all --multi-pod      # every pair, 2x16x16
  python -m repro_torch.launch.dryrun --all --card           # every pair, one card
  python -m repro_torch.launch.dryrun --all --card --both-meshes  # all three
Flags mirroring the reference's levers:
  --seq-parallel    sequence-parallel residual stream (``act_spec``)
  --moe-constrain   MoE dispatch buffers pinned to the expert axis
  --window-cache    window-sized caches for sliding-window layers
  --ssm-chunk N     chunked-remat SSM scan

On the CPU it needs no card; ``measure_on_card`` runs the same step on the
card and reads the peak that the one-card record predicts.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils import flop_counter as _flop_counter
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs, load_all, with_long_variant
from repro_torch.kernels import _lib
from repro_torch.launch.mesh import (
    HW,
    card_memory,
    fake_group_size,
    make_fake_mesh,
    make_production_mesh,
)
from repro_torch.launch.steps import (
    cache_shapes,
    default_opts,
    input_specs,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    opt_shapes,
    param_shapes,
)
from repro_torch.sharding import batch_specs, cache_specs, param_specs, zero1_specs
from repro_torch.sharding.specs import distribute_tree, per_device_bytes
from repro_torch.tree import tree_leaves

HEADROOM = 4 * 2**30  # a one-card peak must leave this much of the card free
ALLOC_ROUND = 512  # the CUDA caching allocator rounds every block up to this
# torch's functional collectives and DTensor's all-to-all (what DTensor's
# redistributions run) under the reference's kinds
# (``repro.launch.dryrun.COLLECTIVE_RE``); any other op of the functional
# collectives' namespace is recorded under its own name
COLLECTIVE_KINDS = {
    "shard_dim_alltoall": "all-to-all",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _wrapped(types) -> str | None:
    """``"dtensor"`` if an op's tensor types hold a DTensor (the modes below
    let it through to DTensor, and see the ops it runs on the local
    shards), ``"fake"`` if they hold a FakeTensor (DTensor's sharding
    propagation, at global shapes: run, not counted), else None."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    if any(issubclass(t, DTensor) for t in types):
        return "dtensor"
    if any(issubclass(t, FakeTensor) for t in types):
        return "fake"
    return None


def _local(t):
    """A DTensor's shard on this rank; any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class LiveBytes(TorchDispatchMode):
    """The bytes of the ``meta`` storages alive on this device, and their
    peak: each op's outputs are added once per storage (a view adds
    nothing), and a weakref finalizer takes a storage off when it dies.
    ``hold`` adds storages made before the mode (the step's arguments; a
    DTensor's local shard). An op on DTensors is let through to DTensor,
    whose ops on the local shards the mode then sees, so the bytes are one
    device's. ``collectives`` counts the functional collectives among them,
    by the reference's kind: calls and result bytes."""

    def __init__(self):
        super().__init__()
        self.sizes: dict[int, int] = {}
        self.live = self.peak = 0
        self.collectives: dict[str, dict] = {}

    def hold(self, t) -> int:
        """Count ``t``'s storage; return the bytes it added (0 if counted)."""
        t = _local(t)
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self.sizes:
            return 0
        n = _rounded(st.nbytes())
        self.sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)
        return n

    def _release(self, key) -> None:
        self.live -= self.sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        wrapped = _wrapped(types)
        if wrapped == "dtensor":
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if wrapped:
            return out
        ns, _, name = func._schema.name.partition("::")
        if ((ns.startswith("_c10d_functional") and name not in NOT_COLLECTIVES)
                or (ns == "_dtensor" and name in COLLECTIVE_KINDS)):
            rec = self.collectives.setdefault(COLLECTIVE_KINDS.get(name, name),
                                              {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += sum(t.numel() * t.element_size() for t in _pytree_leaves(out)
                                if isinstance(t, torch.Tensor))
        for t in _pytree_leaves(out):
            self.hold(t)
        return out


class _LocalFlopMode(_flop_counter._FlopCounterMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        wrapped = _wrapped(types)
        if wrapped == "dtensor":
            return NotImplemented
        if wrapped:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` of one device: an op on DTensors is let through
    to DTensor, and the ops it runs on the local shards are counted (the
    plain ``FlopCounterMode`` counts a DTensor op at its global shape, and
    DTensor's sharding propagation besides). On plain tensors it counts
    what ``FlopCounterMode`` counts."""

    def __enter__(self):
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlopMode(self)
        self.mode.__enter__()
        return self


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages among ``tensors`` (a DTensor's local
    shard), rounded as the allocator rounds them."""
    seen = {}
    for t in map(_local, tensors):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = _rounded(st.nbytes())
    return sum(seen.values())


def trace_step(step, args: tuple) -> dict:
    """Run ``step(*args)`` on ``meta`` arguments (plain, or DTensors with
    ``meta`` shards) under ``LiveBytes``, ``LocalFlopCounter`` and a kernel
    sink. Returns the output, its ``memory`` (argument, output, temp and
    peak bytes), ``cost`` (``flops`` = ``flops_torch`` + ``flops_kernels``,
    and per kernel entry its calls, FLOPs and largest scratch) and
    ``collectives`` (kind -> calls and result bytes), all of one device:
    on DTensors every count is of the shards this rank holds and runs."""
    kernels: dict[str, dict] = {}

    def sink(name, flops, scratch):
        k = kernels.setdefault(name, {"calls": 0, "flops": 0.0, "scratch_bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["scratch_bytes"] = max(k["scratch_bytes"], scratch)

    live = LiveBytes()
    arg_leaves = [t for a in args for t in tree_leaves(a)]
    argument = sum(live.hold(t) for t in arg_leaves)
    counter = LocalFlopCounter(display=False)
    t0 = time.perf_counter()
    with _lib.meta_sink(sink), counter, live:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    flops_torch = float(counter.get_total_flops())
    flops_kernels = sum(k["flops"] for k in kernels.values())
    return dict(
        out=out, trace_s=trace_s,
        memory=dict(argument_bytes=argument,
                    output_bytes=_storage_bytes(tree_leaves(out)),
                    temp_bytes=live.peak - argument, peak_bytes=live.peak),
        cost=dict(flops=flops_torch + flops_kernels, flops_torch=flops_torch,
                  flops_kernels=flops_kernels, kernels=kernels),
        collectives=live.collectives)


def step_inputs(cfg, opts, mode: str, batch: int, seq: int, *, pos: int | None = None):
    """The step and its ``meta`` arguments for one workload: (params,
    opt_state, batch) to train, (params, batch) to prefill, (params, cache,
    batch) to decode one token at ``pos`` (default ``seq - 1``, a full
    cache)."""
    params = param_shapes(cfg, opts)
    specs = input_specs(cfg, batch, seq, mode)
    if mode == "train":
        return make_train_step(cfg, opts), (params, opt_shapes(params), specs)
    if mode == "prefill":
        return make_prefill_step(cfg, opts), (params, specs)
    specs["pos"] = seq - 1 if pos is None else int(pos)
    cache = cache_shapes(cfg, opts, batch, seq)
    return make_serve_step(cfg, opts), (params, cache, specs)


def output_shapes(mode: str, out) -> dict:
    """The step's outputs but the trees it updates: the metrics of a
    training step, the logits of a prefill step, the next token and the
    logits of a decode step; name -> (shape, dtype)."""
    if mode == "train":
        named = out[2]
    elif mode == "prefill":
        named = {"logits": out}
    else:
        named = {"next_token": out[0], "logits": out[1]}
    return {k: (list(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in named.items()}


def one_card(cfg, mode: str, batch: int, seq: int, *, opts=None, pos: int | None = None,
             headroom: int = HEADROOM, card_bytes: int | None = None) -> dict:
    """The one-card record of ``cfg`` (any ``ArchConfig``, cut or not) on a
    workload: ``trace_step`` of ``step_inputs``, with ``fits_one_card``
    (against ``card_bytes``, by default ``card_memory()``) and the step's
    output shapes. ``opts`` defaults to ``default_opts(cfg)`` (one
    device)."""
    opts = opts if opts is not None else default_opts(cfg)
    step, args = step_inputs(cfg, opts, mode, batch, seq, pos=pos)
    traced = trace_step(step, args)
    card = card_bytes if card_bytes is not None else card_memory()
    peak = traced["memory"]["peak_bytes"]
    return dict(
        status="ok", trace_s=round(traced["trace_s"], 3), memory=traced["memory"],
        cost=traced["cost"], card_bytes=card, headroom_bytes=headroom,
        fits_one_card=peak <= card - headroom,
        outputs=output_shapes(mode, traced["out"]),
        collectives={}, hw=HW, num_devices=1)


def reckon_argument_bytes(cfg, opts, shape, mesh) -> int:
    """One device's argument bytes on ``mesh`` from the spec rules (what
    XLA's ``argument_size_in_bytes`` counts): params, ZeRO-1 moments and
    the batch to train; params and the batch to prefill; params, cache and
    the batch to decode."""
    B, S, mode = shape.global_batch, shape.seq_len, shape.mode
    ps = param_shapes(cfg, opts)
    pspec = param_specs(cfg, opts, ps, mesh)
    total = (per_device_bytes(ps, pspec, mesh)
             + per_device_bytes(input_specs(cfg, B, S, mode),
                                batch_specs(cfg, mode, B, mesh), mesh))
    if mode == "train":
        mspec = zero1_specs(pspec, ps, mesh)
        total += per_device_bytes(opt_shapes(ps), {"step": (), "m": mspec, "v": mspec}, mesh)
    elif mode == "decode":
        csh = cache_shapes(cfg, opts, B, S)
        total += per_device_bytes(csh, cache_specs(cfg, opts, csh, mesh, batch=B, seq=S), mesh)
    return total


def mesh_step_inputs(cfg, opts, mode: str, batch: int, seq: int, mesh, *,
                     pos: int | None = None):
    """``step_inputs``' step and arguments laid out on ``mesh`` (a
    ``DeviceMesh``) as the reference's ``in_shardings`` lay them out:
    params by ``param_specs``, the moments by ``zero1_specs``, the batch by
    ``batch_specs``, the cache by ``cache_specs``; ``meta`` arguments
    become DTensors of ``meta`` shards."""
    step, args = step_inputs(cfg, opts, mode, batch, seq, pos=pos)
    params = args[0]
    pspec = param_specs(cfg, opts, params, mesh)
    specs = [pspec]
    if mode == "train":
        mspec = zero1_specs(pspec, params, mesh)
        specs.append({"step": (), "m": mspec, "v": mspec})
    elif mode == "decode":
        specs.append(cache_specs(cfg, opts, args[1], mesh, batch=batch, seq=seq))
    specs.append(batch_specs(cfg, mode, batch, mesh))
    return step, tuple(distribute_tree(a, sp, mesh) for a, sp in zip(args, specs))


def trace_on_mesh(cfg, opts, mode: str, batch: int, seq: int, mesh, *,
                  pos: int | None = None) -> dict:
    """``trace_step`` of ``mesh_step_inputs``: one device's bytes, FLOPs and
    collectives of the step laid out on ``mesh``."""
    step, args = mesh_step_inputs(cfg, opts, mode, batch, seq, mesh, pos=pos)
    return trace_step(step, args)


def sharded(cfg, opts, shape, mesh) -> dict:
    """The production-mesh record: the step traced on DTensors laid out on
    ``mesh`` (a ``DeviceMesh`` over a fake process group of its size,
    ``make_fake_mesh``). ``memory``: ``argument_bytes`` reckoned from the
    spec rules (``reckon_argument_bytes``, XLA's unrounded count),
    ``temp_bytes`` the traced peak over the traced arguments (each storage
    rounded as the allocator rounds it), ``peak_bytes`` their sum,
    ``output_bytes`` the traced outputs' shards; ``cost`` one device's FLOPs;
    ``collectives`` kind -> calls and result bytes of one device. The
    port's repeats are a Python loop, so the collectives are those of the
    whole step (``collectives_counted``), where the reference's
    ``parse_collectives`` counts a scanned body once."""
    traced = trace_on_mesh(cfg, opts, shape.mode, shape.global_batch, shape.seq_len, mesh)
    argument = reckon_argument_bytes(cfg, opts, shape, mesh)
    m = traced["memory"]
    temp = m["peak_bytes"] - m["argument_bytes"]
    return dict(status="ok", trace_s=round(traced["trace_s"], 3),
                memory=dict(argument_bytes=argument, output_bytes=m["output_bytes"],
                            temp_bytes=temp, peak_bytes=argument + temp,
                            traced_argument_bytes=m["argument_bytes"]),
                cost=traced["cost"], collectives=traced["collectives"],
                collectives_counted="whole_step",
                outputs=output_shapes(shape.mode, traced["out"]), hw=HW,
                num_devices=math.prod(mesh.shape))


def shape_skip_reason(cfg, shape_name: str, long_variant: bool) -> str | None:
    if shape_name != "long_500k":
        return None
    if cfg.long_context == "native":
        return None
    if cfg.long_context == "window" and long_variant:
        return None
    if cfg.long_context == "window":
        return ("pure full-attention arch: long_500k skipped by policy "
                "(run with --long-variant for the sliding-window variant)")
    return "no 500k analogue for bounded-context enc-dec audio (DESIGN.md)"


def _write(rec: dict, out_dir: str | None) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{rec['tag']}" if rec["tag"] else ""
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)


def run_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    card: bool = False,
    seq_parallel: bool = False,
    window_cache: bool = False,
    long_variant: bool = False,
    ssm_seq_chunk: int = 0,
    moe_constrain: bool = False,
    out_dir: str | None = "experiments/dryrun",
    tag: str = "",
    card_bytes: int | None = None,
    **opt_overrides,
) -> dict:
    """One (architecture, input shape, mesh) record: on one card
    (``card=True``, mesh ``1x1``; ``card_bytes`` as ``one_card`` takes it)
    the traced step, else the step traced on the production mesh
    (``16x16``, or ``2x16x16`` with ``multi_pod``; ``sharded``) over a fake
    process group, in a child process (``run_records``) unless this process
    already holds a fake group of the mesh's size. ``seq_parallel`` and
    ``moe_constrain`` go to ``default_opts``, as the reference's levers. A
    pair ``shape_skip_reason`` rules out is recorded as skipped with its
    reason."""
    rec, cfg = record_head(arch, shape_name, multi_pod=multi_pod, card=card,
                           seq_parallel=seq_parallel, window_cache=window_cache,
                           long_variant=long_variant, ssm_seq_chunk=ssm_seq_chunk,
                           moe_constrain=moe_constrain, tag=tag)
    if cfg is None:
        _write(rec, out_dir)
        return rec
    shape = INPUT_SHAPES[shape_name]
    spec = None if card else make_production_mesh(multi_pod=multi_pod)
    if spec is not None and fake_group_size() != spec.size:
        job = dict(arch=arch, shape_name=shape_name, multi_pod=multi_pod,
                   seq_parallel=seq_parallel, window_cache=window_cache,
                   long_variant=long_variant, ssm_seq_chunk=ssm_seq_chunk,
                   moe_constrain=moe_constrain, out_dir=out_dir, tag=tag, **opt_overrides)
        (got,) = run_records([job])
        if "error" in got:
            raise RuntimeError(got["error"])
        return got
    mesh = None if card else make_fake_mesh(spec)
    opts = default_opts(cfg, mesh, seq_parallel=seq_parallel, window_cache=window_cache,
                        ssm_seq_chunk=ssm_seq_chunk, moe_constrain=moe_constrain,
                        **opt_overrides)
    if card:
        rec.update(one_card(cfg, shape.mode, shape.global_batch, shape.seq_len, opts=opts,
                            card_bytes=card_bytes))
    else:
        rec.update(sharded(cfg, opts, shape, mesh))
    _write(rec, out_dir)
    return rec


def record_head(arch: str, shape_name: str, *, multi_pod: bool = False, card: bool = False,
                seq_parallel: bool = False, window_cache: bool = False,
                long_variant: bool = False, ssm_seq_chunk: int = 0,
                moe_constrain: bool = False, tag: str = "") -> tuple[dict, object]:
    """A record's head, before any trace: its names and flags, and the
    config to trace (the sliding-window variant with ``long_variant`` at
    ``long_500k``, named under ``arch_variant``); a pair that
    ``shape_skip_reason`` rules out comes back skipped, with its reason and
    no config."""
    cfg = get_arch(arch)
    rec: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "1x1" if card else ("2x16x16" if multi_pod else "16x16"),
        "seq_parallel": seq_parallel, "window_cache": window_cache,
        "ssm_seq_chunk": ssm_seq_chunk, "moe_constrain": moe_constrain,
        "tag": tag,
    }
    skip = shape_skip_reason(cfg, shape_name, long_variant)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec, None
    if long_variant and cfg.long_context == "window" and shape_name == "long_500k":
        cfg = with_long_variant(cfg)
        rec["arch_variant"] = cfg.name
    return rec, cfg


def run_records(jobs: list[dict], *, echo: bool = False) -> list[dict]:
    """``run_one(**job)`` for production-mesh jobs, the jobs of each mesh
    in one child process (``python -m repro_torch.launch.dryrun --jobs``),
    which starts the mesh's fake process group once: a fake group never
    shares a process with a real one, and the import cost is paid once a
    mesh. Returns the records in ``jobs``' order; a job that raised gives
    ``{"error": ...}``. ``echo`` lets the children print a record's line as
    it ends."""
    import subprocess
    import tempfile

    out: list = [None] * len(jobs)
    groups: dict[bool, list[int]] = {}
    for i, job in enumerate(jobs):
        groups.setdefault(bool(job.get("multi_pod")), []).append(i)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    for idx in groups.values():
        with tempfile.TemporaryDirectory() as tmp:
            jobs_path, res_path = os.path.join(tmp, "jobs.json"), os.path.join(tmp, "out.jsonl")
            with open(jobs_path, "w") as f:
                json.dump([jobs[i] for i in idx], f)
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--jobs", jobs_path,
                 "--results", res_path], env=env, text=True,
                stdout=None if echo else subprocess.PIPE, stderr=subprocess.STDOUT)
            got = []
            if os.path.exists(res_path):
                with open(res_path) as f:
                    got = [json.loads(line) for line in f]
            if proc.returncode != 0 or len(got) != len(idx):
                raise RuntimeError(f"the dry run's child process ended with {proc.returncode} "
                                   f"after {len(got)} of {len(idx)} records:\n{proc.stdout}")
            for i, rec in zip(idx, got):
                out[i] = rec
    return out


def _run_jobs(jobs_path: str, results_path: str) -> None:
    """A child of ``run_records``: each job's record (or its error) as one
    JSON line of ``results_path``, its line printed."""
    with open(jobs_path) as f:
        jobs = json.load(f)
    if jobs:  # the mesh's fake group, started once for every job
        make_fake_mesh(make_production_mesh(multi_pod=bool(jobs[0].get("multi_pod"))))
    with open(results_path, "w") as out:
        for job in jobs:
            try:
                rec = run_one(**job)
                print(record_line(rec), flush=True)
            except Exception as e:  # noqa: BLE001 - every failure is reported
                traceback.print_exc()
                rec = {"error": f"{job['arch']} {job['shape_name']}: {type(e).__name__}: {e}"}
                print(f"[FAIL] {rec['error']}", flush=True)
            out.write(json.dumps(rec, default=float) + "\n")
            out.flush()


def measure_on_card(cfg, mode: str, batch: int, seq: int, *, opts=None,
                    pos: int | None = None, seed: int = 0, device="cuda") -> dict:
    """Run ``step_inputs``' step once on the card with real arguments
    (``init_params``, ``adamw_init``, random tokens, zero media, frames and
    cache): the bytes allocated just before the arguments are made
    (``base_bytes``), the arguments' bytes, ``torch.cuda.max_memory_allocated``
    over the base from the arguments to the end of the step (``peak_bytes``,
    comparable with the one-card record's), the step's wall s (ending in a
    sync) and its outputs but the trees it updates (a training step's
    metrics, a prefill step's logits, a decode step's next token and
    logits)."""
    import gc

    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.optim import adamw_init

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_on_card reads the card's allocator: pass a CUDA device")
    opts = opts if opts is not None else default_opts(cfg)
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    step, meta_args = step_inputs(cfg, opts, mode, batch, seq, pos=pos)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def real(spec):
        if spec.dtype in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab_size, spec.shape, dtype=spec.dtype, device=dev,
                                 generator=gen)
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)

    params = init_params(cfg, opts, seed=seed, device=dev)
    b = {k: (real(v) if isinstance(v, torch.Tensor) else v) for k, v in meta_args[-1].items()}
    if mode == "train":
        args = (params, adamw_init(params), b)
    elif mode == "prefill":
        args = (params, b)
    else:
        args = (params, init_cache(cfg, opts, batch, seq, getattr(torch, cfg.compute_dtype),
                                   device=dev), b)
    del meta_args
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    argument = torch.cuda.memory_allocated(dev) - base
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    # the trees the step updates go with the arguments
    out = out[2] if mode == "train" else out if mode == "prefill" else out[:2]
    del args
    return dict(base_bytes=base, argument_bytes=argument, peak_bytes=peak, step_s=step_s,
                out=out)


def within_bar(measured: int, predicted: int, rel: float = 0.05,
               floor: int = 512 * 2**20) -> bool:
    """Whether a measured peak lies within 5% or 512 MiB (the larger) of
    the one-card record's."""
    return abs(measured - predicted) <= max(rel * predicted, floor)


def record_line(rec: dict) -> str:
    a, s, m = rec["arch"], rec["shape"], rec["mesh"]
    if rec["status"] != "ok":
        return f"[SKIP] {a:24s} {s:12s} {m:8s} {rec['reason']}"
    mem = rec["memory"]
    head = (f"[OK]   {a:24s} {s:12s} {m:8s} trace {rec['trace_s']:6.1f}s "
            f"arg {mem['argument_bytes'] / 1e9:9.2f}GB temp {mem['temp_bytes'] / 1e9:9.2f}GB "
            f"peak {mem['peak_bytes'] / 1e9:9.2f}GB flops {rec['cost']['flops']:.4g}")
    if rec["mesh"] == "1x1":
        return head + f" fits {rec['fits_one_card']}"
    coll = " ".join(f"{k} {v['count']}x{v['bytes'] / 1e9:.3g}GB"
                    for k, v in sorted(rec["collectives"].items()))
    return head + f" | {coll or 'no collectives'}"


def main(argv=None):
    load_all()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--card", action="store_true",
                    help="trace the step on one card (mesh 1x1)")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--window-cache", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--moe-constrain", action="store_true")
    ap.add_argument("--long-variant", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--jobs", help=argparse.SUPPRESS)  # a child of run_records
    ap.add_argument("--results", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.jobs:
        _run_jobs(args.jobs, args.results)
        return

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]
    meshes = [dict(card=True)] if args.card else []
    if args.both_meshes:
        meshes += [dict(multi_pod=False), dict(multi_pod=True)]
    elif args.multi_pod or not args.card:
        meshes.append(dict(multi_pod=args.multi_pod))
    common = dict(seq_parallel=args.seq_parallel, window_cache=args.window_cache,
                  long_variant=args.long_variant, ssm_seq_chunk=args.ssm_chunk,
                  moe_constrain=args.moe_constrain, out_dir=args.out, tag=args.tag)

    failures = 0
    t0 = time.perf_counter()
    for a, s in pairs if any(m.get("card") for m in meshes) else []:
        try:
            print(record_line(run_one(a, s, card=True, **common)), flush=True)
        except Exception as e:  # noqa: BLE001 - every failure is reported
            failures += 1
            print(f"[FAIL] {a:24s} {s:12s} 1x1 {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    jobs = [dict(arch=a, shape_name=s, multi_pod=m["multi_pod"], **common)
            for m in meshes if not m.get("card") for a, s in pairs]
    if jobs:
        failures += sum("error" in rec for rec in run_records(jobs, echo=True))
    print(f"dry run: {len(pairs) * len(meshes)} records in {time.perf_counter() - t0:.1f} s, "
          f"{failures} failed", flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
