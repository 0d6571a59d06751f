"""End-to-end comparison: FedEEC vs FedAgg vs HierFAVG on synthetic SVHN-like
data — a scaled-down Table III row, with the convergence curves of Fig. 5
and the communication comparison of Table VII. Counterpart of
``examples/fedeec_vs_baselines.py``.

    PYTHONPATH=src python -m repro_torch.examples.fedeec_vs_baselines
    PYTHONPATH=src python -m repro_torch.examples.fedeec_vs_baselines --rounds 2 --device cpu
    # any registered algorithms, e.g. every baseline:
    ... --algorithms hierfavg,hiermo,hierqsgd,demlearn,fedavg
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.fedeec_vs_baselines")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--algorithms", default="fedeec,fedagg,hierfavg")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import run_experiment

    cfg = FLConfig(
        dataset="synth_svhn",
        num_clients=10,
        num_edges=2,
        samples_per_client=64,
        rounds=args.rounds,
        test_samples=256,
    )
    results = {}
    for alg in args.algorithms.split(","):
        print(f"== {alg} ==")
        results[alg] = run_experiment(alg, cfg, verbose=True, eval_every=4,
                                      device=args.device)

    print("\n=== summary (cloud model accuracy) ===")
    for alg, r in results.items():
        comm = sum(r.comm_bytes.values()) / 1e6
        print(f"{alg:10s} best={r.best_acc:.4f} final={r.final_acc:.4f} "
              f"total comm={comm:.2f} MB")
    return results


if __name__ == "__main__":
    main()
