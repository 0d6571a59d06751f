"""FL experiment configuration for the PyTorch port.

A copy of the FL plane of ``repro.configs.base``: ``FLConfig`` holds the
FedEEC paper-scale experiment (tree topology, models per tier, dataset,
hyperparameters). The transformer ``ArchConfig`` plane belongs to the LM
slice of the port and is not here yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    """FedEEC paper-scale experiment configuration (Section V of the paper)."""

    dataset: str = "synth_cifar10"  # synth_svhn | synth_cifar10 | synth_cinic10
    num_classes: int = 10
    image_size: int = 16
    num_clients: int = 20
    num_edges: int = 5
    dirichlet_alpha: float = 2.0
    samples_per_client: int = 64
    test_samples: int = 512

    # models per tier (names resolved by repro_torch.models.registry)
    end_model: str = "cnn1"
    end_model_hetero: str = ""  # if set, half the ends use this model
    edge_model: str = "resnet10"
    cloud_model: str = "resnet18"

    # optimization (paper §V-B.5: lr=0.001, batch=8, κ1=κ2=1 —
    # one local minibatch per client per round for aggregation baselines;
    # BSBODP runs one pass over the pair's stored embeddings per round,
    # capped at max_distill_steps)
    lr: float = 1e-3
    batch_size: int = 8
    rounds: int = 30
    local_steps: int = 1
    distill_steps: int = 0  # 0 = one pass over the pair's embeddings
    max_distill_steps: int = 10

    # FedEEC hyperparameters (paper defaults)
    temperature: float = 0.5  # T
    beta: float = 1.5  # distillation weight
    gamma: float = 1.0  # leaf local/distill mix
    queue_len: int = 20  # B

    # autoencoder
    embed_dim: int = 32
    seed: int = 0

    # network simulation: name of a scenario, or "" for the plain
    # (round-counted) execution path — the only path the port runs so far
    scenario: str = ""
