"""Dry run: every (architecture x input shape x mesh) combination sized
without allocating a byte of it.

Counterpart of ``repro.launch.dryrun``. For each combination:

* on a production mesh (``16x16``, ``2x16x16``; ``launch.mesh.MeshSpec``,
  no devices) it builds the inputs' shapes (``launch.steps``' meta trees),
  lays them out by the spec rules (``repro_torch.sharding``) and reckons
  one device's ``argument_bytes`` (params, ZeRO-1 moments and the batch to
  train; params and the batch to prefill; params, cache and the batch to
  decode: what XLA's ``argument_size_in_bytes`` counts) and
  ``output_bytes`` (from the reference's ``out_shardings``; an output the
  reference leaves to the compiler is reckoned replicated). The port has
  no SPMD partitioner, so ``temp_bytes`` and ``collectives`` are ``None``
  with a ``not_traced`` reason;
* on one card (``card=True``, mesh ``1x1``) it runs the real step of
  ``launch.steps`` on ``meta`` inputs under ``trace_step``: a
  ``TorchDispatchMode`` that keeps the bytes of every live storage (each
  op's new outputs added, each storage's release taken off by a weakref
  finalizer, sizes rounded up to the caching allocator's 512 bytes), with
  the kernels' scratch, which their wrappers allocate on ``meta`` as on
  the card; ``FlopCounterMode`` for the torch ops, plus the FLOPs each
  kernel declares through ``kernels._lib.meta_launch``. Its record holds
  ``memory`` (``argument_bytes``, ``output_bytes``, ``temp_bytes`` = the
  peak over the arguments, ``peak_bytes``), ``cost`` and ``fits_one_card``
  (the peak at least ``HEADROOM`` under the card's memory).

Records go to ``<out_dir>/<arch>__<shape>__<mesh>[__<tag>].json``, as the
reference's file names.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all                  # every pair, 16x16
  python -m repro_torch.launch.dryrun --all --multi-pod      # every pair, 2x16x16
  python -m repro_torch.launch.dryrun --all --card           # every pair, one card
  python -m repro_torch.launch.dryrun --all --card --both-meshes  # all three
Flags mirroring the reference's levers:
  --window-cache    window-sized caches for sliding-window layers
  --ssm-chunk N     chunked-remat SSM scan
  --seq-parallel, --moe-constrain   refused: they lay out DTensors, and the
                    port traces none yet (ROADMAP A7.7), so no record would
                    model them

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
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs, load_all, with_long_variant
from repro_torch.kernels import _lib
from repro_torch.launch.mesh import HW, card_memory, make_production_mesh
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
from repro_torch.models.layers import padded_vocab
from repro_torch.sharding import batch_specs, cache_specs, param_specs, zero1_specs
from repro_torch.sharding.specs import per_device_bytes
from repro_torch.tree import tree_leaves

HEADROOM = 4 * 2**30  # a one-card peak must leave this much of the card free
ALLOC_ROUND = 512  # the CUDA caching allocator rounds every block up to this
NOT_TRACED = ("the port has no SPMD partitioner: per-device temporaries and "
              "collectives are not traced on a production mesh")
LAYOUTS_REFUSED = ("seq_parallel and moe_constrain lay out DTensors, and the dry run traces "
                   "none yet (ROADMAP A7.7): no record would model them")


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


class LiveBytes(TorchDispatchMode):
    """The bytes of the ``meta`` storages alive, and their peak: each op's
    outputs are added once per storage (a view adds nothing), and a weakref
    finalizer takes a storage off when it dies. ``hold`` adds storages made
    before the mode (the step's arguments)."""

    def __init__(self):
        super().__init__()
        self.sizes: dict[int, int] = {}
        self.live = self.peak = 0

    def hold(self, t) -> int:
        """Count ``t``'s storage; return the bytes it added (0 if counted)."""
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
        out = func(*args, **(kwargs or {}))
        for t in _pytree_leaves(out):
            self.hold(t)
        return out


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages among ``tensors``, rounded as the
    allocator rounds them."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = _rounded(st.nbytes())
    return sum(seen.values())


def trace_step(step, args: tuple) -> dict:
    """Run ``step(*args)`` on ``meta`` arguments under ``LiveBytes``,
    ``FlopCounterMode`` and a kernel sink. Returns the output, its
    ``memory`` (argument, output, temp and peak bytes) and ``cost``
    (``flops`` = ``flops_torch`` + ``flops_kernels``, and per kernel entry
    its calls, FLOPs and largest scratch)."""
    kernels: dict[str, dict] = {}

    def sink(name, flops, scratch):
        k = kernels.setdefault(name, {"calls": 0, "flops": 0.0, "scratch_bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["scratch_bytes"] = max(k["scratch_bytes"], scratch)

    live = LiveBytes()
    arg_leaves = [t for a in args for t in tree_leaves(a)]
    argument = sum(live.hold(t) for t in arg_leaves)
    counter = FlopCounterMode(display=False)
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
                  flops_kernels=flops_kernels, kernels=kernels))


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


def sharded(cfg, opts, shape, mesh) -> dict:
    """The production-mesh record: per-device argument and output bytes
    from the spec rules, nothing traced."""
    B, S, mode = shape.global_batch, shape.seq_len, shape.mode
    ps = param_shapes(cfg, opts)
    pspec = param_specs(cfg, opts, ps, mesh)
    specs = input_specs(cfg, B, S, mode)
    bspec = batch_specs(cfg, mode, B, mesh)
    cdt = getattr(torch, cfg.compute_dtype)
    logits = (B, padded_vocab(cfg.vocab_size))
    params_b = per_device_bytes(ps, pspec, mesh)
    batch_b = per_device_bytes(specs, bspec, mesh)
    if mode == "train":
        osh = opt_shapes(ps)
        mspec = zero1_specs(pspec, ps, mesh)
        ospec = {"step": (), "m": mspec, "v": mspec}
        opt_b = per_device_bytes(osh, ospec, mesh)
        argument = params_b + opt_b + batch_b
        output = params_b + opt_b + 4 * 4  # + loss, ce, grad_norm, lb_loss (fp32)
    elif mode == "prefill":
        argument = params_b + batch_b
        output = math.prod(logits) * cdt.itemsize  # left to the compiler: replicated
    else:
        csh = cache_shapes(cfg, opts, B, S)
        cspec = cache_specs(cfg, opts, csh, mesh, batch=B, seq=S)
        cache_b = per_device_bytes(csh, cspec, mesh)
        argument = params_b + cache_b + batch_b
        output = B * 4 + math.prod(logits) * cdt.itemsize + cache_b
    return dict(status="ok", memory=dict(argument_bytes=argument, output_bytes=output,
                                         temp_bytes=None),
                cost=None, collectives=None, not_traced=NOT_TRACED, hw=HW,
                num_devices=mesh.size)


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
    the traced step, else the production mesh (``16x16``, or ``2x16x16``
    with ``multi_pod``) reckoned from the spec rules. A pair
    ``shape_skip_reason`` rules out is recorded as skipped with its
    reason. ``seq_parallel`` and ``moe_constrain`` are refused
    (``LAYOUTS_REFUSED``)."""
    if seq_parallel or moe_constrain:
        raise NotImplementedError(LAYOUTS_REFUSED)
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "1x1" if card else ("2x16x16" if multi_pod else "16x16")
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "seq_parallel": seq_parallel, "window_cache": window_cache,
        "ssm_seq_chunk": ssm_seq_chunk, "moe_constrain": moe_constrain,
        "tag": tag,
    }
    skip = shape_skip_reason(cfg, shape_name, long_variant)
    if skip:
        rec.update(status="skipped", reason=skip)
        _write(rec, out_dir)
        return rec
    if long_variant and cfg.long_context == "window" and shape_name == "long_500k":
        cfg = with_long_variant(cfg)
        rec["arch_variant"] = cfg.name
    mesh = None if card else make_production_mesh(multi_pod=multi_pod)
    opts = default_opts(cfg, mesh, window_cache=window_cache, ssm_seq_chunk=ssm_seq_chunk,
                        **opt_overrides)
    t0 = time.perf_counter()
    if card:
        rec.update(one_card(cfg, shape.mode, shape.global_batch, shape.seq_len, opts=opts,
                            card_bytes=card_bytes))
    else:
        rec.update(sharded(cfg, opts, shape, mesh))
        rec["reckon_s"] = round(time.perf_counter() - t0, 3)
    _write(rec, out_dir)
    return rec


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
    if rec["mesh"] == "1x1":
        return (f"[OK]   {a:24s} {s:12s} {m:8s} trace {rec['trace_s']:6.1f}s "
                f"arg {mem['argument_bytes'] / 1e9:9.2f}GB temp {mem['temp_bytes'] / 1e9:9.2f}GB "
                f"peak {mem['peak_bytes'] / 1e9:9.2f}GB flops {rec['cost']['flops']:.4g} "
                f"fits {rec['fits_one_card']}")
    return (f"[OK]   {a:24s} {s:12s} {m:8s} reckon {rec['reckon_s']:6.1f}s "
            f"arg {mem['argument_bytes'] / 1e9:7.2f}GB out {mem['output_bytes'] / 1e9:7.2f}GB "
            f"temp not traced")


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
    args = ap.parse_args(argv)
    if args.seq_parallel or args.moe_constrain:
        ap.error(LAYOUTS_REFUSED)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    pairs = [(a, s) for a in archs for s in shapes]
    meshes = [dict(card=True)] if args.card else []
    if args.both_meshes:
        meshes += [dict(multi_pod=False), dict(multi_pod=True)]
    elif args.multi_pod or not args.card:
        meshes.append(dict(multi_pod=args.multi_pod))

    failures = 0
    for mesh in meshes:
        for a, s in pairs:
            try:
                rec = run_one(a, s, **mesh, window_cache=args.window_cache,
                              long_variant=args.long_variant, ssm_seq_chunk=args.ssm_chunk,
                              out_dir=args.out, tag=args.tag)
                print(record_line(rec), flush=True)
            except Exception as e:  # noqa: BLE001 - every failure is reported
                failures += 1
                print(f"[FAIL] {a:24s} {s:12s} {mesh} {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
