"""rwkv6-1.6b [ssm] — "Finch": attention-free, token-shift time-mix with
data-dependent decay, channel-mix FFN. [arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def rwkv6_1_6b() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        citation="arXiv:2404.05892",
        num_layers=24,
        d_model=2048,
        num_heads=32,  # time-mix heads (head_dim 64)
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        pattern=(BlockKind("rwkv6"),),
        n_repeats=24,
        norm="layernorm",  # RWKV uses LayerNorm
        mlp_act="sq_relu",  # channel-mix uses relu^2
        ssm_state=64,  # per-head state is head_dim x head_dim
        ssm_heads=32,
        ssm_head_dim=64,
        long_context="native",  # O(1) recurrent state
        max_seq_len=1_048_576,
    )
