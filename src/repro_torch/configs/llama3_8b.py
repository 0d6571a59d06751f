"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def llama3_8b() -> ArchConfig:
    return ArchConfig(
        name="llama3-8b",
        family="dense",
        citation="arXiv:2407.21783",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        pattern=(BlockKind("attn"),),
        n_repeats=32,
        norm="rmsnorm",
        mlp_act="silu_glu",
        rope_theta=500_000.0,
        long_context="window",
    )
