"""End-to-end trainers.

Counterpart of ``repro.launch.train``. Two planes:

  FL plane (the paper):
    python -m repro_torch.launch.train --fl --algorithm fedeec --rounds 30
  LM plane (real steps of the transformer zoo):
    python -m repro_torch.launch.train --arch llama3.2-3b --reduced --steps 50 --device cpu
    python -m repro_torch.launch.train --arch llama3.2-3b --full --steps 4 --batch 2 \\
        --seq 1024 --use-kernels --profile-last 1  # on the card: full width and depth, bf16
    python -m repro_torch.launch.train --arch rwkv6-1.6b --full --steps 4 --batch 2 \\
        --seq 1024 --use-kernels  # rwkv6 on the card: the scan's kernels forward and backward
    python -m repro_torch.launch.train --arch zamba2-7b --reduced --steps 10 --device cpu

Both run on the card by default; ``--device cpu`` (or ``device="cpu"``)
runs the plain path on the CPU. ``train_lm`` runs ``make_train_step`` with
the reference's options (``attn_chunk=0, remat=False``; ``rwkv_chunk`` and
``ssm_seq_chunk`` at their defaults, so an rwkv6 model's time mix runs
``ops.rwkv6_scan``, its forward and backward kernels on the card);
``remat=True`` recomputes each repeat of the unit in the backward pass,
which zamba2-7b needs at full width on one card; ``use_kernels``
sends the LM loss through ``distill_loss``'s cross-entropy kernels (bf16
logits at full size, no teacher tensor). ``profile_last`` runs the last steps under ``torch.profiler`` and
reports where their device time goes. ``checkpoint`` (``--checkpoint
PATH``) saves ``{"params", "opt"}`` after the run in the reference's
checkpoint format (``repro_torch.checkpoint``), which
``repro.checkpoint.load_pytree`` reads as well.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.configs.base import ArchConfig, FLConfig
from repro_torch.data.loader import token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import default_opts, input_specs, make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves


@dataclass
class TrainResult:
    losses: list[float] = field(default_factory=list)  # per step
    grad_norms: list[float] = field(default_factory=list)  # per step, before clipping
    step_s: list[float] = field(default_factory=list)  # wall s per step, ends in a sync
    tokens_per_step: int = 0
    n_params: int = 0
    profile: dict | None = None  # the profiled steps' device breakdown

    @property
    def tokens_per_s(self) -> list[float]:
        return [self.tokens_per_step / max(s, 1e-9) for s in self.step_s]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# A profiler window in a process that has run the profiler before can lose
# its first kernel records (ROADMAP C14). The training step's window opens
# with this many marker kernels (``torch.cuda._sleep``'s ``spin_kernel``,
# which nothing else launches) and a sync, before the first profiled step's
# clock starts; the breakdown leaves them out and reports how many were
# lost: while one marker is seen, the loss ended before the step's kernels.
PROFILE_LEAD_IN = 256


def _device_breakdown(prof, steps: int, wall_s: float, top: int = 8) -> dict:
    """Device busy s per step (the union of kernel intervals), its idle
    share of ``wall_s`` (an unprofiled step's wall time: the profiler slows
    the host), kernels per step, the ``top`` kernels by device time, and
    the markers of the window's lead-in that the profiler lost
    (``markers_lost``; all of them lost means the steps' first records may
    be lost too), and the device s per step of the kernels launched inside
    each ``record_function`` range opened in the window (``ranges``)."""
    from torch.autograd import DeviceType

    from repro_torch.fl.profile_round import busy_us

    everything = prof.events()
    # a record_function range also leaves a span on the device's timeline,
    # which is not a kernel
    ranges = {e.name for e in everything if getattr(e, "is_user_annotation", False)}
    events = [e for e in everything
              if e.device_type == DeviceType.CUDA and e.name not in ranges]
    kernels = [e for e in events if "spin_kernel" not in e.name]
    lost = PROFILE_LEAD_IN - (len(events) - len(kernels))
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6 / steps
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6 / steps
    return dict(busy_s=busy, idle_share=1 - busy / wall_s,
                kernels_per_step=len(kernels) / steps,
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:top], markers_lost=lost,
                ranges=range_times(everything, steps))


def range_times(events, steps: int) -> dict[str, float]:
    """Device s per step of the kernels launched inside each
    ``record_function`` range (a user annotation of the profiler), each
    kernel counted once, under its outermost range: a CPU op's kernels
    belong to the outermost annotation among its ancestors on its thread.
    A backward range opened and closed by tensor hooks runs on the
    autograd thread, and so holds the backward's ops."""
    out: dict[str, float] = {}
    for e in events:
        if not e.kernels or getattr(e, "is_user_annotation", False):
            continue
        outer, p = None, e.cpu_parent
        while p is not None:
            if getattr(p, "is_user_annotation", False):
                outer = p.name
            p = p.cpu_parent
        if outer is not None:
            out[outer] = out.get(outer, 0.0) + sum(k.duration for k in e.kernels) / 1e6 / steps
    return out


def stub_inputs(cfg, batch: int, device) -> dict[str, torch.Tensor]:
    """The stubbed frontends' inputs of a training batch, zeros with
    ``input_specs``' shapes and dtypes as the reference's ``train_lm`` feeds
    them: its split of 32 positions gives ``media`` the reference's
    min(num_media_tokens, 16) rows, and ``frames`` has enc_seq_len rows."""
    specs = input_specs(cfg, batch, 32, "train")
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in specs.items() if k not in ("tokens", "labels")}


def train_lm(arch: str | ArchConfig, *, steps: int = 50, batch: int = 8,
             seq: int = 128,
             use_reduced: bool = True, lr: float = 1e-3, seed: int = 0,
             checkpoint: str | None = None, log_every: int = 10,
             use_kernels: bool = False, profile_last: int = 0, remat: bool = False,
             device="cuda") -> TrainResult:
    """Train ``arch`` (a registered name, reduced unless
    ``use_reduced=False``, or an ``ArchConfig`` taken as it is) for
    ``steps`` steps on ``token_batches`` data. Each batch is made and copied to the
    device before its step's clock starts; a step's wall time ends in a
    sync. The last ``profile_last`` steps (fewer than ``steps``) run under
    ``torch.profiler``; ``profile`` then holds their device breakdown, its
    idle share against the wall time of the step before them. Raises if a
    loss is not finite. ``remat`` checkpoints each repeat of the unit
    (``ModelOpts.remat``; the reference's ``train_lm`` runs without).
    ``checkpoint`` names a file that receives
    ``{"params", "opt"}`` after the run, in the reference's layout
    (``convert.lm_to_jax`` / ``lm_adamw_to_jax``)."""
    if not 0 <= profile_last < steps:
        raise ValueError(f"profile_last {profile_last} must be below steps {steps}")
    dev = resolve_device(device)
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = reduced(get_arch(arch)) if use_reduced else get_arch(arch)
    opts = default_opts(cfg, attn_chunk=0, remat=remat, use_kernels=use_kernels)
    params = init_params(cfg, opts, seed=seed, device=dev)
    opt_state = adamw_init(params)
    res = TrainResult(tokens_per_step=batch * seq,
                      n_params=sum(t.numel() for t in tree_leaves(params)))
    print(f"[train_lm] {cfg.name}: {res.n_params / 1e6:.2f}M params on {dev.type}, "
          f"batch {batch} x seq {seq}, use_kernels={use_kernels}, remat={remat}")

    step = make_train_step(cfg, opts, lr=lr)
    gen = token_batches(np.random.default_rng(seed), cfg.vocab_size, batch, seq)
    with contextlib.ExitStack() as profiled:
        for i in range(steps):
            if profile_last and i == steps - profile_last:
                from torch.profiler import ProfilerActivity, profile

                prof = profiled.enter_context(
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                if dev.type == "cuda":
                    for _ in range(PROFILE_LEAD_IN):
                        torch.cuda._sleep(1)
            b = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in next(gen).items()}
            b.update(stub_inputs(cfg, batch, dev))
            _sync(dev)
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, b)
            _sync(dev)
            res.step_s.append(time.perf_counter() - t0)
            res.losses.append(float(m["loss"]))
            res.grad_norms.append(float(m["grad_norm"]))
            if (i + 1) % log_every == 0:
                print(f"  step {i + 1:4d} loss {res.losses[-1]:.4f} grad_norm "
                      f"{res.grad_norms[-1]:.4f} ({res.step_s[-1]:.4f} s, "
                      f"{res.tokens_per_s[-1]:.1f} tokens/s)", flush=True)
    if profile_last:
        res.profile = _device_breakdown(prof, profile_last, res.step_s[-profile_last - 1])
        p = res.profile
        print(f"[train_lm] the last {profile_last} step(s) under torch.profiler: device busy "
              f"{p['busy_s']:.4f} s per step, idle share {p['idle_share']:.4f} of step "
              f"{steps - profile_last}'s wall, {p['kernels_per_step']:.1f} kernels per step "
              f"({p['markers_lost']} of a lead-in of {PROFILE_LEAD_IN} markers lost)")
        for name, sec in p["top"]:
            print(f"  {1e3 * sec:10.4f} ms  {name[:90]}")
    if not np.isfinite(res.losses).all():
        raise FloatingPointError(f"{cfg.name}: non-finite loss {res.losses}")
    if checkpoint:
        save_pytree(checkpoint, {"params": convert.lm_to_jax(params),
                                 "opt": convert.lm_adamw_to_jax(opt_state)})
        print(f"[train_lm] checkpoint -> {checkpoint}")
    print(f"[train_lm] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} over {steps} steps")
    return res


def train_fl(algorithm: str = "fedeec", device="cuda", **kw):
    from repro_torch.fl.engine import run_experiment

    rounds = kw.pop("rounds", None)
    cfg = FLConfig(**{k: v for k, v in kw.items() if v is not None})
    res = run_experiment(algorithm, cfg, rounds=rounds, verbose=True, device=device)
    print(f"[train_fl] {algorithm}: best cloud acc {res.best_acc:.4f}; "
          f"comm {res.comm_bytes}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fl", action="store_true")
    ap.add_argument("--algorithm", default="fedeec")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--num-clients", type=int, default=None)
    ap.add_argument("--num-edges", type=int, default=None)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--arch", choices=list_archs(), default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--profile-last", type=int, default=0,
                    help="run the last N steps under torch.profiler")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fl:
        return train_fl(args.algorithm, device=args.device, rounds=args.rounds,
                        num_clients=args.num_clients, num_edges=args.num_edges,
                        dataset=args.dataset)
    return train_lm(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                    use_reduced=args.reduced, lr=args.lr, checkpoint=args.checkpoint,
                    use_kernels=args.use_kernels, profile_last=args.profile_last,
                    device=args.device)


if __name__ == "__main__":
    main()
