"""Where a FedEEC round's time goes on the card.

    PYTHONPATH=src python -m repro_torch.fl.profile_round
    PYTHONPATH=src python -m repro_torch.fl.profile_round --scenario mobile_clients

Builds the problem at ``FLConfig()`` defaults on the card, runs one round
(it pays the one-off set-up), times the next round without the
profiler, then runs one more round under
``torch.profiler`` and reports: the round's host wall time, the device's
busy time (the union of kernel intervals) and idle share, the number of
kernels launched, the port's kernel launches by name (SKR's by entry: one
``fused`` launch a teacher step), and the kernels that take the most
device time. The
profiler slows the host, so the idle share is reported against the
unprofiled round's wall time too. The rounds are plain rounds, or with
``--scenario`` the simulator's rounds of that scenario (churn, scheduling
and the pairs that run; the engine's host time is inside the round). A
scenario's timed and profiled rounds are consecutive rounds, whose churn
can run different pairs, so there the profiled round's own idle share is
the consistent one.
"""
from __future__ import annotations

import argparse
import time

TOP = 12  # kernels and host operators listed


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.fl.profile_round")
    ap.add_argument("--scenario", default="",
                    help="run the simulator's rounds of this scenario "
                         "instead of plain rounds")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.kernels import ops
    from repro_torch.kernels.skr_rectify import variant_launches as skr_variants

    cfg = FLConfig()
    _, tree, client_data, auto = build_problem(cfg, device="cuda")
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device="cuda")
    step = trainer.train_round
    if args.scenario:
        from repro_torch.sim.engine import SimEngine
        from repro_torch.sim.scenarios import get_scenario

        engine = SimEngine(trainer, get_scenario(args.scenario), seed=cfg.seed)

        def step():
            engine.run(len(engine.round_s) + 1)

    step()
    torch.cuda.synchronize()
    # the profiler's wall times are host-only measurements, read after the
    # round and never part of its event log
    t0 = time.perf_counter()  # analysis: allow[DET001]
    step()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0  # analysis: allow[DET001]

    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()  # analysis: allow[DET001]
        step()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0  # analysis: allow[DET001]
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device activity")
    busy_s = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    print(f"device: {torch.cuda.get_device_name(0)}")
    if args.scenario:
        print(f"scenario {args.scenario}: events so far {engine.log.counts()}")
    print(f"round wall s: {wall_plain:.4f} unprofiled, {wall_prof:.4f} profiled")
    print(f"device busy s: {busy_s:.4f}  idle share: {1 - busy_s / wall_plain:.4f} of the "
          f"unprofiled round, {1 - busy_s / wall_prof:.4f} of the profiled one")
    print(f"kernels launched in the round: {len(kernels)}")
    print(f"port kernel launches in the round: {dict(ops.launches)}; skr_rectify by "
          f"entry: {dict(skr_variants)}")
    print("top kernels by device time (total ms, count, mean us):")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:TOP]
    for name, ts in top:
        print(f"  {sum(ts) / 1e3:9.3f} ms  {len(ts):7d}  {sum(ts) / len(ts):8.2f}  {name[:90]}")
    print("top host operators by self CPU time (profiled round):")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=TOP))


if __name__ == "__main__":
    main()
