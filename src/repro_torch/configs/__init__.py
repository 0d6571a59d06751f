"""Config package: the ArchConfig registry and the FL experiment presets."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_REGISTRY,
    ArchConfig,
    BlockKind,
    FLConfig,
    INPUT_SHAPES,
    InputShape,
    get_arch,
    list_archs,
    reduced,
    register_arch,
)


def load_all() -> None:
    """Import the architectures the port runs (registration side effects);
    the reference's other nine wait for their block kinds (ROADMAP A6.3)."""
    from repro_torch.configs import llama3_2_3b, rwkv6_1_6b  # noqa: F401
