"""llava-next-mistral-7b [vlm] — Mistral-7B language backbone consuming anyres
vision-patch embeddings from a stubbed SigLIP/CLIP+projector frontend.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Per the assignment, the vision tower is a STUB: ``input_specs`` provides
pre-computed patch embeddings of shape (batch, num_media_tokens, d_model);
the framework implements the transformer backbone that consumes them
(patch embeddings are prepended to the text-token embeddings — anyres
tiling yields up to 5 tiles x 576 patches = 2880 media tokens).
"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def llava_next_mistral_7b() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        pattern=(BlockKind("attn"),),
        n_repeats=32,
        norm="rmsnorm",
        mlp_act="silu_glu",
        rope_theta=1_000_000.0,
        frontend="vision_stub",
        num_media_tokens=2880,  # anyres: 5 tiles x 24x24 patches
        long_context="window",
    )
