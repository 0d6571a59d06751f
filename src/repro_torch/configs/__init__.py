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
    with_long_variant,
)


def load_all() -> None:
    """Import the architectures the port runs (registration side effects);
    the reference's other two wait for the encoder-decoder model and the
    media frontend (ROADMAP A6.3)."""
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite_16b,
        gemma3_12b,
        llama3_2_3b,
        llama3_8b,
        nemotron_4_15b,
        qwen2_moe_a2_7b,
        rwkv6_1_6b,
        zamba2_7b,
    )
