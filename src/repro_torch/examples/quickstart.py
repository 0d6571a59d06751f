"""Quickstart: a 3-tier FedEEC run on synthetic CIFAR-10-like data,
counterpart of ``examples/quickstart.py``.

Runs the full pipeline — synthetic dataset, Dirichlet non-IID partition,
autoencoder pre-training on the open split, tier-scaled models
(CNN -> ResNet-10 -> ResNet-18), BSBODP+SKR rounds — and prints the cloud
model accuracy curve.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --rounds 2 --device cpu
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import run_experiment

    cfg = FLConfig(
        dataset="synth_cifar10",
        num_clients=6,
        num_edges=2,
        samples_per_client=48,
        rounds=args.rounds,
        test_samples=256,
    )
    print("== FedEEC quickstart:", cfg.num_clients, "clients,", cfg.num_edges, "edges ==")
    res = run_experiment("fedeec", cfg, verbose=True, eval_every=2, device=args.device)
    print(f"\nbest cloud accuracy: {res.best_acc:.4f}")
    print(f"communication bytes: { {k: f'{v/1e6:.2f} MB' for k, v in res.comm_bytes.items()} }")


if __name__ == "__main__":
    main()
