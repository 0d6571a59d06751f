"""deepseek-v2-lite-16b [moe] — MLA attention (kv_lora=512) + fine-grained MoE:
layer 0 dense (d_ff=10944), layers 1..26 MoE with 64 routed experts top-6 and
2 shared experts (expert hidden 1408). [arXiv:2405.04434]

Note on the assignment line "2 shared+160 routed top-6": DeepSeek-V2 (full)
uses 160 routed experts, the *Lite* model uses 64; the primary spec in the
assignment ("MoE 64e top-6") matches Lite, so 64 routed experts are used here
and the 160-expert full-size routing is available via ``num_experts`` override.
"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def deepseek_v2_lite_16b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        citation="arXiv:2405.04434",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,  # MLA: latent cache, head count applies to Q
        head_dim=128,
        d_ff=1408,  # routed expert hidden (assignment: d_ff=1408)
        vocab_size=102400,
        head_blocks=(BlockKind("mla"),),  # layer 0: dense MLP
        pattern=(BlockKind("mla_moe"),),
        n_repeats=26,
        norm="rmsnorm",
        mlp_act="silu_glu",
        rope_theta=10_000.0,
        # MLA dims (DeepSeek-V2-Lite)
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        # MoE dims
        num_experts=64,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        shared_d_ff=2 * 1408,
        dense_d_ff=10944,
        long_context="native",  # MLA compressed KV cache: 576 B/token/layer
    )
