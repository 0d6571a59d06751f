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
    """Import every architecture of the reference (registration side
    effects); the port runs them all."""
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite_16b,
        gemma3_12b,
        llama3_2_3b,
        llama3_8b,
        llava_next_mistral_7b,
        nemotron_4_15b,
        qwen2_moe_a2_7b,
        rwkv6_1_6b,
        whisper_small,
        zamba2_7b,
    )
