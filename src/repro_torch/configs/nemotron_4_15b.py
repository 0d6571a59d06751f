"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP, LayerNorm. [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def nemotron_4_15b() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b",
        family="dense",
        citation="arXiv:2402.16819",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        pattern=(BlockKind("attn"),),
        n_repeats=32,
        norm="layernorm",
        mlp_act="sq_relu",  # squared ReLU, non-gated
        rope_theta=10_000.0,
        long_context="window",
    )
