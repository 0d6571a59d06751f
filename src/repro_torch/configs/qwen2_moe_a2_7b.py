"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def qwen2_moe_a2_7b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        pattern=(BlockKind("moe"),),
        n_repeats=24,
        norm="rmsnorm",
        mlp_act="silu_glu",
        rope_theta=1_000_000.0,
        num_experts=60,
        num_shared_experts=4,
        moe_top_k=4,
        moe_d_ff=1408,
        shared_d_ff=5632,
        long_context="window",
    )
