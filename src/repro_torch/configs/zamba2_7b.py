"""zamba2-7b [hybrid] — Mamba2 backbone with a single *shared* full-attention
transformer block interleaved every 6th layer. [arXiv:2411.15242]

81 layers total = 13 x (5 mamba2 + 1 shared-attn) + 3 tail mamba2 blocks.
The shared-attn block has ONE parameter copy reused at every occurrence
(zamba2's core trick for parameter efficiency); each occurrence keeps its
own KV cache.
"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def zamba2_7b() -> ArchConfig:
    m = BlockKind("mamba2")
    s = BlockKind("shared_attn", shared=True)
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        citation="arXiv:2411.15242",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,  # MHA in the shared block
        head_dim=112,  # 3584 / 32
        d_ff=14336,
        vocab_size=32000,
        pattern=(m, m, m, m, m, s),
        n_repeats=13,
        tail_blocks=(m, m, m),
        norm="rmsnorm",
        mlp_act="gelu_glu",
        rope_theta=10_000.0,
        ssm_state=64,
        d_inner=7168,  # 2 x d_model
        ssm_heads=112,  # d_inner / 64
        ssm_head_dim=64,
        conv_width=4,
        long_context="native",
    )
