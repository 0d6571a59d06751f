"""CLI for scenario-driven simulated FL runs, counterpart of
``repro.sim.runner``.

    python -m repro_torch.sim.runner --scenario mobile_clients --rounds 3
    python -m repro_torch.sim.runner --list
    python -m repro_torch.sim.runner --scenario trace_replay --verify --device cpu

Prints the event log and the accuracy-vs-simulated-seconds curve;
``--out`` writes the event log as JSON; ``--verify`` runs the scenario
twice with the same seed and checks that the event signatures are
identical (determinism proof). ``--metrics OUT.json`` writes the
metrics-registry snapshot, ``--profile-sim`` records the scheduler's host
phase times, and ``--faults <plan>`` overrides the scenario's fault plan.
``--checkpoint-every N`` snapshots the run every N rounds (into
``--checkpoint-dir``, by default ``checkpoints/<scenario>``), ``--resume
DIR`` continues from a snapshot (the port's or the reference's), and
``--verify-resume`` stops a second run at the midpoint with a snapshot,
resumes it to the end and checks it against the uninterrupted run:

    python -m repro_torch.sim.runner --algorithm hierfavg --scenario regional_outage --verify-resume

``--trace OUT.json`` writes the run's Chrome trace (open it in
https://ui.perfetto.dev, or read it with ``python -m
repro_torch.obs.report``) and ``--explain-rounds`` prints each round's
critical path from the event log:

    python -m repro_torch.sim.runner --scenario straggler_heavy --rounds 1 --clients 4 --edges 2 --trace t.json --explain-rounds --device cpu

Runs on the card by default; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import sys


def build_cfg(args):
    from repro_torch.configs.fedeec_paper import paper_setting

    return paper_setting(
        args.dataset,
        args.clients,
        args.edges,
        samples_per_client=args.samples,
        test_samples=args.test_samples,
        image_size=args.image_size,
        embed_dim=args.embed_dim,
        seed=args.seed,
        scenario=args.scenario,
    )


def describe(res, max_events: int) -> None:
    print(f"\n== event log ({len(res.event_log)} events, "
          f"signature {res.event_signature}) ==")
    shown = res.event_log if len(res.event_log) <= max_events else (
        res.event_log[: max_events // 2]
        + [{"t": "...", "kind": f"... {len(res.event_log) - max_events} more ..."}]
        + res.event_log[-max_events // 2:]
    )
    for e in shown:
        t = e["t"] if isinstance(e["t"], str) else f"{e['t']:10.3f}"
        extra = {k: v for k, v in e.items()
                 if k not in ("t", "seq", "kind", "ord")}
        print(f"  t={t}  {e['kind']:<12} {extra if extra else ''}")
    print(f"\n== event counts ==\n  {res.event_counts}")
    print("\n== accuracy vs simulated wall-clock ==")
    for t, acc in res.sim_curve:
        print(f"  sim t = {t:10.1f}s   cloud acc = {acc:.4f}")
    print(f"\nsimulated run length: {res.sim_wall_s:.1f}s "
          f"(best acc {res.best_acc:.4f}, real wall {res.wall_s:.1f}s)")
    print("round host s (ending in a device sync):",
          [round(s, 4) for s in res.round_s])
    print("comm bytes by link:", {k: round(v) for k, v in res.comm_bytes.items()})


def main(argv=None) -> int:
    from repro_torch.sim.scenarios import get_scenario, list_scenarios

    ap = argparse.ArgumentParser(
        prog="repro_torch.sim.runner",
        description="Discrete-event EEC-NET scenario runner (PyTorch port)",
    )
    ap.add_argument("--scenario", default="stable",
                    help="scenario name, or comma-separated list to run "
                         "several in one process")
    ap.add_argument("--algorithm", default="fedeec")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--edges", type=int, default=3)
    ap.add_argument("--dataset", default="synth_cifar10")
    ap.add_argument("--samples", type=int, default=32,
                    help="samples per client")
    ap.add_argument("--test-samples", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--embed-dim", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--max-events", type=int, default=60,
                    help="max event-log lines to print")
    ap.add_argument("--out", default="", help="write event log JSON here")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace (Perfetto) of the run here")
    ap.add_argument("--metrics", default="",
                    help="write the metrics-registry snapshot JSON here")
    ap.add_argument("--explain-rounds", action="store_true",
                    help="print per-round critical-path attribution")
    ap.add_argument("--profile-sim", action="store_true",
                    help="record host-side scheduler throughput "
                         "(sim_events_per_second gauge) and a per-phase "
                         "wall-clock breakdown in the metrics registry, "
                         "and print both after the run")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--verify", action="store_true",
                    help="run twice, check identical event signatures")
    ap.add_argument("--faults", default="",
                    help="fault plan name (repro_torch.sim.faults) overriding "
                         "the scenario's; 'none' disables faults")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot engine state every N rounds")
    ap.add_argument("--checkpoint-dir", default="",
                    help="checkpoint directory (default: "
                         "checkpoints/<scenario> when --checkpoint-every)")
    ap.add_argument("--resume", default="",
                    help="resume from a checkpoint directory; the "
                         "continued run is bit-identical to an "
                         "uninterrupted one")
    ap.add_argument("--verify-resume", action="store_true",
                    help="kill-and-resume proof: run to the midpoint, "
                         "checkpoint, resume to the end, check the event "
                         "log against the uninterrupted run's")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' for "
                         "a run without a card)")
    args = ap.parse_args(argv)

    if args.list:
        for name in list_scenarios():
            sc = get_scenario(name)
            print(f"{name:<18} {sc.description}")
        return 0

    names = [s.strip() for s in args.scenario.split(",") if s.strip()]
    for name in names:
        try:
            get_scenario(name)  # fail fast on unknown names
        except KeyError:
            print(f"error: unknown scenario {name!r}; known: "
                  f"{', '.join(list_scenarios())}", file=sys.stderr)
            return 2
    from repro_torch.fl.api import list_algorithms
    from repro_torch.fl.engine import run_experiment

    if args.algorithm.lower() not in list_algorithms():
        print(f"error: unknown algorithm {args.algorithm!r}; known: "
              f"{', '.join(list_algorithms())}", file=sys.stderr)
        return 2

    if args.faults:
        from repro_torch.sim.faults import list_fault_plans

        if args.faults not in list_fault_plans():
            print(f"error: unknown fault plan {args.faults!r}; known: "
                  f"{', '.join(list_fault_plans())}", file=sys.stderr)
            return 2

    rc = 0
    for name in names:
        args.scenario = name
        cfg = build_cfg(args)
        ckpt_dir = args.checkpoint_dir or (
            f"checkpoints/{name}" if args.checkpoint_every else "")
        print(f"scenario={name} algorithm={args.algorithm} "
              f"rounds={args.rounds} clients={cfg.num_clients} "
              f"edges={cfg.num_edges} seed={cfg.seed} device={args.device}"
              + (f" faults={args.faults}" if args.faults else ""))
        tracer = None
        if args.trace:
            from repro_torch.obs.trace import Tracer

            tracer = Tracer()
        res = run_experiment(args.algorithm, cfg, rounds=args.rounds,
                             eval_every=args.eval_every, verbose=True,
                             tracer=tracer,
                             faults=args.faults or None,
                             checkpoint_every=args.checkpoint_every,
                             checkpoint_dir=ckpt_dir,
                             resume_from=args.resume,
                             profile_sim=args.profile_sim,
                             device=args.device)
        describe(res, args.max_events)

        if args.profile_sim:
            eps = res.metrics.get("sim_events_per_second", {}).get("value", 0)
            print(f"\n== simulator profile ==\n  events/sec: {eps:,.1f}")
            phases = sorted(
                (name[len("sim_profile_"):-len("_seconds")], m["value"])
                for name, m in res.metrics.items()
                if name.startswith("sim_profile_")
                and name.endswith("_seconds"))
            for phase, secs in phases:
                print(f"  {phase:<10} {secs:9.3f}s")

        def _path(opt):
            return opt if len(names) == 1 else f"{name}.{opt}"

        if args.out:
            import json

            with open(_path(args.out), "w") as f:
                json.dump(res.event_log, f, indent=1)
            print(f"\nevent log written to {_path(args.out)}")

        if tracer is not None:
            tracer.to_json(_path(args.trace))
            print(f"\nChrome trace written to {_path(args.trace)} "
                  "(open in https://ui.perfetto.dev)")

        if args.metrics:
            import json

            from repro_torch.obs.metrics import global_registry

            snap = dict(res.metrics)
            snap.update(global_registry().snapshot())
            with open(_path(args.metrics), "w") as f:
                json.dump(snap, f, indent=1, sort_keys=True)
            print(f"metrics snapshot written to {_path(args.metrics)}")

        if args.explain_rounds:
            from repro_torch.obs.critical_path import (
                explain,
                rounds_from_eventlog,
            )

            print("\n== critical-path attribution ==")
            print(explain(rounds_from_eventlog(res.event_log)))

        if args.verify:
            res2 = run_experiment(args.algorithm, cfg, rounds=args.rounds,
                                  eval_every=args.eval_every,
                                  faults=args.faults or None,
                                  device=args.device)
            same = res2.event_signature == res.event_signature
            print(f"\nreplay signature {res2.event_signature} "
                  f"{'== original (deterministic)' if same else '!= ORIGINAL'}")
            if not same:
                rc = 1

        if args.verify_resume and not verify_resume(args, cfg, res):
            rc = 1
        print()
    return rc


def _schedule(res):
    """The event log without its evals: the schedule, which holds bit for
    bit on every device."""
    return [{k: v for k, v in e.items() if k != "ord"}
            for e in res.event_log if e["kind"] != "eval"]


def verify_resume(args, cfg, res) -> bool:
    """Kill-and-resume proof: stop a run at the midpoint with a checkpoint,
    resume it to the end, and compare it with the uninterrupted run
    ``res``. On the CPU the signatures must be equal; on a card, whose
    runs are not bitwise repeatable (cuDNN's backward, ROADMAP.md C5), the
    eval entries' accuracies may differ, so the event log without evals
    and the eval times are held, and the signatures are reported."""
    import tempfile

    from repro_torch.fl.engine import run_experiment

    half = max(1, args.rounds // 2)
    with tempfile.TemporaryDirectory() as ckpt:
        run_experiment(args.algorithm, cfg, rounds=args.rounds,
                       eval_every=args.eval_every, faults=args.faults or None,
                       stop_after=half, checkpoint_every=half,
                       checkpoint_dir=ckpt, device=args.device)
        res3 = run_experiment(args.algorithm, cfg, rounds=args.rounds,
                              eval_every=args.eval_every,
                              faults=args.faults or None, resume_from=ckpt,
                              device=args.device)
    same = res3.event_signature == res.event_signature
    print(f"kill-and-resume signature {res3.event_signature} "
          f"{'== uninterrupted (checkpoint-resume exact)' if same else '!= UNINTERRUPTED'}")
    import torch

    if torch.device(args.device).type == "cpu":
        return same
    sched = _schedule(res3) == _schedule(res) and res3.sim_times == res.sim_times
    print(f"kill-and-resume event log without evals and eval times "
          f"{'== uninterrupted' if sched else '!= UNINTERRUPTED'}; accuracy "
          f"{res3.acc_curve} vs {res.acc_curve}")
    return sched


if __name__ == "__main__":
    sys.exit(main())
