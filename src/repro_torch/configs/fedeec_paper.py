"""Paper-plane FL experiment presets (Section V of the FedEEC paper).

The paper evaluates on SVHN / CIFAR-10 / CINIC-10 with 50/100/500 clients and
5/10/20 edges. The datasets are class-conditional synthetic stand-ins with
matching shape and class count (see ``repro_torch.data.synthetic``);
experiment scale is reduced while preserving every algorithmic knob (β, γ,
T, B, Dirichlet α, tiers). The presets that name a scenario run through
the simulator (``repro_torch.sim``).
"""
from dataclasses import replace

from repro_torch.configs.base import FLConfig

# Default experiment, mirrors the paper's CIFAR-10 / 50-client setting
# (scaled: 20 clients, 5 edges, 16x16 synthetic images).
DEFAULT = FLConfig()


def paper_setting(
    dataset: str = "synth_cifar10",
    num_clients: int = 20,
    num_edges: int = 5,
    **overrides,
) -> FLConfig:
    return replace(
        DEFAULT, dataset=dataset, num_clients=num_clients, num_edges=num_edges,
        **overrides,
    )


# Named presets used by benchmarks (one per paper table).
PRESETS: dict[str, FLConfig] = {
    # Table III rows (per dataset x client-count).
    "svhn_small": paper_setting("synth_svhn", 10, 2),
    "svhn_mid": paper_setting("synth_svhn", 20, 5),
    "cifar10_small": paper_setting("synth_cifar10", 10, 2),
    "cifar10_mid": paper_setting("synth_cifar10", 20, 5),
    "cinic10_small": paper_setting("synth_cinic10", 10, 2),
    "cinic10_mid": paper_setting("synth_cinic10", 20, 5),
    # Table V: device heterogeneity (half the ends run cnn2)
    "cifar10_hetero": paper_setting(
        "synth_cifar10", 10, 2, end_model_hetero="cnn2"
    ),
    # §IV-E migration-resilience under simulated network conditions
    "cifar10_mobile": paper_setting(
        "synth_cifar10", 10, 3, scenario="mobile_clients"
    ),
    "cifar10_flaky": paper_setting(
        "synth_cifar10", 10, 3, scenario="flaky_edge"
    ),
    "cifar10_stragglers": paper_setting(
        "synth_cifar10", 10, 3, scenario="straggler_heavy"
    ),
    "cifar10_flash_crowd": paper_setting(
        "synth_cifar10", 10, 3, scenario="flash_crowd"
    ),
}
