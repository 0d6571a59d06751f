"""Dynamic node migration (paper §IV-E, Theorems 1-2), counterpart of
``examples/dynamic_migration.py``.

A client migrates to a different edge server mid-training. Under
BSBODP+SKR (an equivalence interaction protocol) the migration is always
legal and training continues; a partial-order protocol would reject the
same move. Accuracy is reported before/after to show the run is unharmed.

    PYTHONPATH=src python -m repro_torch.examples.dynamic_migration
    PYTHONPATH=src python -m repro_torch.examples.dynamic_migration --rounds 2 --device cpu
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.dynamic_migration")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.core.protocols import BSBODP_SKR, PARTIAL_TRAIN
    from repro_torch.fl.engine import run_experiment

    cfg = FLConfig(num_clients=6, num_edges=2, samples_per_client=48,
                   rounds=args.rounds, test_samples=256)
    at = args.rounds // 2
    print(f"== FedEEC with a client migrating at round {at} ==")
    res = run_experiment("fedeec", cfg, verbose=True, eval_every=2,
                         migration_round=at, device=args.device)
    print(f"best cloud accuracy with migration: {res.best_acc:.4f}")

    # protocol-level check (Theorem 1 vs Theorem 2): migrating a node whose
    # model is LARGER than the prospective parent's — the paper's Case 2.2
    # counterexample (¬ Model(7) ⊑ Model(5))
    fake_models = {"client0": {"w": torch.zeros((8, 8))},
                   "edge1": {"w": torch.zeros((4, 4))}}
    model_of = fake_models.get
    print("\nequivalence protocol allows the move:",
          BSBODP_SKR.allows_migration(model_of, "client0", "edge1"))  # True (Thm 1)
    print("partial-order protocol allows the move:",
          PARTIAL_TRAIN.allows_migration(model_of, "client0", "edge1"))  # False (Thm 2)


if __name__ == "__main__":
    main()
