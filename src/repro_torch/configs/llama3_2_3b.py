"""llama3.2-3b [dense] — small llama3, tied embeddings. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def llama3_2_3b() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b",
        family="dense",
        citation="hf:meta-llama/Llama-3.2-1B",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        pattern=(BlockKind("attn"),),
        n_repeats=28,
        norm="rmsnorm",
        mlp_act="silu_glu",
        rope_theta=500_000.0,
        tie_embeddings=True,
        long_context="window",
    )
