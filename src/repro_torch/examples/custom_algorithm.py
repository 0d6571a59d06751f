"""Register a custom FL algorithm on the work-item API, counterpart of
``examples/custom_algorithm.py``.

``SampledFedAvg`` subsamples half the clients each round — the classic
FedAvg client-sampling knob — purely by reshaping ``work_items``; the
scheduler, the simulator and participation accounting pick it up
unchanged. ``main`` registers it for the length of its runs (importing
this module, or running ``main``, leaves the registry as it was).

    PYTHONPATH=src python -m repro_torch.examples.custom_algorithm
    PYTHONPATH=src python -m repro_torch.examples.custom_algorithm --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.fl.baselines import HierarchicalFedAvg

NAME = "fedavg_sampled"


class SampledFedAvg(HierarchicalFedAvg):
    """HierFAVG with deterministic per-round client sampling."""

    def work_items(self, round, online):
        items = super().work_items(round, online)
        clients = sorted(self.client_data)
        rng = np.random.default_rng((self.cfg.seed, round))
        keep = set(rng.choice(clients, size=max(1, len(clients) // 2),
                              replace=False))
        return [it for it in items
                if it.kind != "local" or it.node in keep]


def _build(cfg, tree, client_data, auto, *, device="cuda"):
    return SampledFedAvg(cfg, tree, client_data, seed=cfg.seed, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.custom_algorithm")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.api import ALGORITHM_REGISTRY, register_algorithm
    from repro_torch.fl.engine import run_experiment

    cfg = FLConfig(num_clients=8, num_edges=2, samples_per_client=32,
                   test_samples=256)
    register_algorithm(NAME)(_build)
    try:
        print("== sampled FedAvg, plain path ==")
        res = run_experiment(NAME, cfg, rounds=4, verbose=True, device=args.device)
        print(f"best cloud accuracy: {res.best_acc:.4f}")

        print("\n== same algorithm, scheduled by the network simulator ==")
        res = run_experiment(NAME, cfg, rounds=3, scenario="mobile_clients",
                             device=args.device)
    finally:
        del ALGORITHM_REGISTRY[NAME]
    started = {e["node"] for e in res.event_log if e["kind"] == "pair_start"}
    print(f"sim length {res.sim_wall_s:.1f}s, work items ran on: "
          f"{sorted(v for v in started if v.startswith('client'))}")
    print(f"event counts: {res.event_counts}")


if __name__ == "__main__":
    main()
