"""gemma3-12b [dense] — 5:1 local:global sliding-window attention, 128k context,
256k vocab, GeGLU, QK-norm. [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def gemma3_12b() -> ArchConfig:
    local = BlockKind("local_attn")
    glob = BlockKind("attn")
    return ArchConfig(
        name="gemma3-12b",
        family="dense",
        citation="hf:google/gemma-3-1b-pt",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        # 5 local : 1 global, 8 repeats = 48 layers
        pattern=(local, local, local, local, local, glob),
        n_repeats=8,
        norm="rmsnorm",
        mlp_act="gelu_glu",
        rope_theta=1_000_000.0,  # global layers
        local_rope_theta=10_000.0,  # local layers
        sliding_window=1024,
        qk_norm=True,
        tie_embeddings=True,
        max_seq_len=131_072,
        long_context="native",  # only 8/48 layers attend globally
    )
