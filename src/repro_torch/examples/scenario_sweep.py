"""Sweep FedEEC across simulated network scenarios (``repro_torch.sim``),
counterpart of ``examples/scenario_sweep.py``.

Runs the same FedEEC problem under every registered scenario and prints
a comparison table: best accuracy, simulated wall-clock, the churn the
run survived, and how many of the run's pair items ran in coalesced
groups.

    PYTHONPATH=src python -m repro_torch.examples.scenario_sweep [--rounds N]
    PYTHONPATH=src python -m repro_torch.examples.scenario_sweep --rounds 1 --device cpu
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.scenario_sweep")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--edges", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.fedeec_paper import paper_setting
    from repro_torch.fl.engine import run_experiment
    from repro_torch.sim.scenarios import list_scenarios

    cfg = paper_setting("synth_cifar10", args.clients, args.edges,
                        samples_per_client=32, test_samples=256)
    print(f"{'scenario':<18} {'best_acc':>8} {'sim_s':>8} {'migrations':>10} "
          f"{'dropouts':>8} {'skipped':>8} {'coalesced':>11}")
    for name in list_scenarios():
        res = run_experiment("fedeec", cfg, rounds=args.rounds, scenario=name,
                             device=args.device)
        c, d = res.event_counts, res.dispatch_stats
        print(f"{name:<18} {res.best_acc:>8.4f} {res.sim_wall_s:>8.1f} "
              f"{c.get('migrate', 0):>10} {c.get('dropout', 0):>8} "
              f"{c.get('pair_skip', 0):>8} {d['batched_items']:>5}/{d['items']:<5}")


if __name__ == "__main__":
    main()
