"""whisper-small [audio] — encoder-decoder; conv/mel frontend is a STUB:
``input_specs`` provides pre-computed frame embeddings (batch, 1500, d_model)
standing in for the mel-spectrogram + 2-conv feature extractor output.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, BlockKind, register_arch


@register_arch
def whisper_small() -> ArchConfig:
    return ArchConfig(
        name="whisper-small",
        family="audio",
        citation="arXiv:2212.04356",
        num_layers=12,  # decoder layers (with cross-attention)
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        pattern=(BlockKind("attn"),),
        n_repeats=12,
        norm="layernorm",
        mlp_act="gelu",  # non-gated GELU MLP
        learned_pos_emb=True,
        enc_dec=True,
        enc_layers=12,
        enc_seq_len=1500,  # 30 s of audio at 50 Hz after the conv stub
        frontend="audio_stub",
        tie_embeddings=True,
        long_context="skip",  # bounded 30 s source context; no 500k analogue
        max_seq_len=32_768,
    )
