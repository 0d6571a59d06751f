"""Config system for the PyTorch port.

Two planes of configuration, copies of those in ``repro.configs.base``:

* ``ArchConfig`` — a production-scale transformer-family architecture. The
  port registers every architecture of the reference
  (``deepseek_v2_lite_16b``, ``gemma3_12b``, ``llama3_2_3b``,
  ``llama3_8b``, ``llava_next_mistral_7b``, ``nemotron_4_15b``,
  ``qwen2_moe_a2_7b``, ``rwkv6_1_6b``, ``whisper_small``, ``zamba2_7b``).
* ``FLConfig`` — the FedEEC paper-scale experiment (tree topology, models
  per tier, dataset, hyperparameters).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned; fixed across all architectures)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch, mode) workload."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockKind:
    """One block in the repeating layer pattern of an architecture.

    kind:
      "attn"        — self-attention (GQA) + MLP block
      "local_attn"  — sliding-window self-attention + MLP block
      "mla"         — multi-head latent attention + MLP block
      "moe"         — self-attention + MoE-FFN block
      "mla_moe"     — MLA attention + MoE-FFN block
      "rwkv6"       — RWKV6 time-mix + channel-mix block (attention free)
      "mamba2"      — Mamba2 SSD block
      "shared_attn" — a *shared* full attention+MLP block (single param copy
                      reused at every occurrence; zamba2 style)
    """

    kind: str
    shared: bool = False


@dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    citation: str

    # core dims -----------------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer pattern -------------------------------------------------------
    # The model is built as `pattern × n_repeats` followed by `tail`.
    # num_layers == len(pattern) * n_repeats + len(tail) + len(head)
    pattern: Tuple[BlockKind, ...] = (BlockKind("attn"),)
    n_repeats: int = 0
    head_blocks: Tuple[BlockKind, ...] = ()
    tail_blocks: Tuple[BlockKind, ...] = ()

    # normalization / activation -------------------------------------------
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp_act: str = "silu_glu"  # silu_glu | gelu_glu | sq_relu | gelu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # attention -----------------------------------------------------------
    rope_theta: float = 10_000.0
    local_rope_theta: float = 0.0  # gemma3 uses a different theta locally
    sliding_window: int = 0  # window size for "local_attn" blocks
    qk_norm: bool = False

    # MLA (deepseek) --------------------------------------------------------
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE -------------------------------------------------------------------
    num_experts: int = 0  # routed experts (logical)
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per (routed) expert hidden
    shared_d_ff: int = 0  # combined shared-expert hidden
    dense_d_ff: int = 0  # hidden of leading dense layers (deepseek layer 0)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # SSM -------------------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    d_inner: int = 0
    conv_width: int = 4
    ssm_chunk: int = 256

    # frontends / enc-dec ---------------------------------------------------
    frontend: Optional[str] = None  # "vision_stub" | "audio_stub"
    num_media_tokens: int = 0  # patch/frame embeddings provided by the stub
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq_len: int = 0
    learned_pos_emb: bool = False

    # numerics ---------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    max_seq_len: int = 131_072

    # long-context policy ------------------------------------------------
    # "native"  — architecture is natively sub-quadratic / long-context capable
    # "window"  — beyond-paper sliding-window variant available via
    #             with_long_variant(); skipped by default
    # "skip"    — no 500k analogue (documented in DESIGN.md)
    long_context: str = "window"

    def sanity(self) -> None:
        n_pat = len(self.pattern) * self.n_repeats
        n = n_pat + len(self.tail_blocks) + len(self.head_blocks)
        assert n == self.num_layers, (
            f"{self.name}: pattern covers {n} layers, config says {self.num_layers}"
        )

    @property
    def blocks(self) -> Tuple[BlockKind, ...]:
        """The fully unrolled layer list (for reference implementations)."""
        return (
            self.head_blocks
            + self.pattern * self.n_repeats
            + self.tail_blocks
        )

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for rooflines."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        for blk in self.blocks:
            total += _block_params(self, blk)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts only)."""
        d, V = self.d_model, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        for blk in self.blocks:
            total += _block_params(self, blk, active_only=True)
        return total


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    q = d * cfg.num_heads * cfg.head_dim
    kv = 2 * d * cfg.num_kv_heads * cfg.head_dim
    o = cfg.num_heads * cfg.head_dim * d
    return q + kv + o


def _mla_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    n = cfg.num_heads
    down = d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    up = cfg.kv_lora_rank * n * (cfg.qk_nope_dim + cfg.v_head_dim)
    q = d * n * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    o = n * cfg.v_head_dim * d
    return down + up + q + o


def _mlp_params(d: int, ff: int, act: str) -> int:
    return d * ff * (3 if act.endswith("_glu") else 2)


def _block_params(cfg: ArchConfig, blk: BlockKind, active_only: bool = False) -> int:
    d = cfg.d_model
    k = blk.kind
    if k in ("attn", "local_attn"):
        return _attn_params(cfg) + _mlp_params(d, cfg.d_ff, cfg.mlp_act)
    if k == "shared_attn":
        # shared params counted once; amortized cost approximated as full
        return _attn_params(cfg) + _mlp_params(d, cfg.d_ff, cfg.mlp_act)
    if k == "mla":
        return _mla_params(cfg) + _mlp_params(d, cfg.dense_d_ff or cfg.d_ff, cfg.mlp_act)
    if k in ("moe", "mla_moe"):
        attn = _mla_params(cfg) if k == "mla_moe" else _attn_params(cfg)
        n_routed = cfg.moe_top_k if active_only else cfg.num_experts
        routed = n_routed * _mlp_params(d, cfg.moe_d_ff, cfg.mlp_act)
        shared = _mlp_params(d, cfg.shared_d_ff, cfg.mlp_act) if cfg.shared_d_ff else 0
        router = d * cfg.num_experts
        return attn + routed + shared + router
    if k == "rwkv6":
        # time-mix: r,k,v,w,g projections + output; channel-mix: 2 mats
        tm = 5 * d * d + d * d
        cm = d * cfg.d_ff + cfg.d_ff * d
        lora = 6 * (d * 32 * 2)  # data-dependent mixing loras (approx)
        return tm + cm + lora
    if k == "mamba2":
        din = cfg.d_inner
        in_proj = d * (2 * din + 2 * cfg.ssm_state * 2 + cfg.ssm_heads)
        out_proj = din * d
        conv = (din + 2 * cfg.ssm_state * 2) * cfg.conv_width
        return in_proj + out_proj + conv
    raise ValueError(f"unknown block kind {k}")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register_arch(fn: Callable[[], ArchConfig]):
    cfg = fn()
    cfg.sanity()
    ARCH_REGISTRY[cfg.name] = fn
    return fn


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_REGISTRY:
        # import side-effect registration
        from repro_torch import configs as _c  # noqa

        _c.load_all()
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    cfg = ARCH_REGISTRY[name]()
    cfg.sanity()
    return cfg


def list_archs() -> list[str]:
    from repro_torch import configs as _c

    _c.load_all()
    return sorted(ARCH_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced (smoke) variants
# ---------------------------------------------------------------------------


def reduced(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family variant: ≤2 pattern repeats, d_model ≤ 512,
    ≤4 experts — runs one forward/train step on CPU in the smoke tests."""
    d = min(cfg.d_model, 128)
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, 2))
    hd = 32
    num_e = min(cfg.num_experts, 4) if cfg.num_experts else 0
    changes = dict(
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=max(64, d * 2),
        vocab_size=min(cfg.vocab_size, 512),
        n_repeats=min(cfg.n_repeats, 1) if cfg.n_repeats else 0,
        head_blocks=cfg.head_blocks[:1],
        tail_blocks=cfg.tail_blocks[:1],
        num_experts=num_e,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_d_ff=min(cfg.moe_d_ff, 64) if cfg.moe_d_ff else 0,
        shared_d_ff=min(cfg.shared_d_ff, 64) if cfg.shared_d_ff else 0,
        dense_d_ff=min(cfg.dense_d_ff, 128) if cfg.dense_d_ff else 0,
        num_shared_experts=min(cfg.num_shared_experts, 2),
        kv_lora_rank=min(cfg.kv_lora_rank, 32) if cfg.kv_lora_rank else 0,
        qk_nope_dim=32 if cfg.qk_nope_dim else 0,
        qk_rope_dim=16 if cfg.qk_rope_dim else 0,
        v_head_dim=32 if cfg.v_head_dim else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        d_inner=2 * d if cfg.d_inner else 0,
        # rwkv6: heads tile d_model; mamba2: heads tile d_inner (=2*d here)
        ssm_heads=(
            ((2 * d) // 32 if cfg.d_inner else d // 32) if cfg.ssm_heads else 0
        ),
        ssm_head_dim=32 if cfg.ssm_head_dim else 0,
        ssm_chunk=16,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        enc_layers=min(cfg.enc_layers, 2),
        enc_seq_len=min(cfg.enc_seq_len, 32),
        num_media_tokens=min(cfg.num_media_tokens, 16),
        param_dtype="float32",
        compute_dtype="float32",
        max_seq_len=256,
    )
    new = replace(cfg, **changes)
    n_layers = (
        len(new.pattern) * new.n_repeats
        + len(new.tail_blocks)
        + len(new.head_blocks)
    )
    new = replace(new, num_layers=n_layers)
    new.sanity()
    return new


def with_long_variant(cfg: ArchConfig, window: int = 8_192) -> ArchConfig:
    """Beyond-paper: convert a pure full-attention arch into a sliding-window
    variant so that long_500k becomes architecturally meaningful."""
    def _swap(blocks):
        return tuple(
            BlockKind("local_attn", b.shared) if b.kind == "attn" else b
            for b in blocks
        )

    return replace(
        cfg,
        name=cfg.name + "-sw",
        pattern=_swap(cfg.pattern),
        head_blocks=_swap(cfg.head_blocks),
        tail_blocks=_swap(cfg.tail_blocks),
        sliding_window=window,
        long_context="native",
    )


# ---------------------------------------------------------------------------
# FL (paper-plane) configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FLConfig:
    """FedEEC paper-scale experiment configuration (Section V of the paper)."""

    dataset: str = "synth_cifar10"  # synth_svhn | synth_cifar10 | synth_cinic10
    num_classes: int = 10
    image_size: int = 16
    num_clients: int = 20
    num_edges: int = 5
    dirichlet_alpha: float = 2.0
    samples_per_client: int = 64
    test_samples: int = 512

    # models per tier (names resolved by repro_torch.models.registry)
    end_model: str = "cnn1"
    end_model_hetero: str = ""  # if set, half the ends use this model
    edge_model: str = "resnet10"
    cloud_model: str = "resnet18"

    # optimization (paper §V-B.5: lr=0.001, batch=8, κ1=κ2=1 —
    # one local minibatch per client per round for aggregation baselines;
    # BSBODP runs one pass over the pair's stored embeddings per round,
    # capped at max_distill_steps)
    lr: float = 1e-3
    batch_size: int = 8
    rounds: int = 30
    local_steps: int = 1
    distill_steps: int = 0  # 0 = one pass over the pair's embeddings
    max_distill_steps: int = 10

    # FedEEC hyperparameters (paper defaults)
    temperature: float = 0.5  # T
    beta: float = 1.5  # distillation weight
    gamma: float = 1.0  # leaf local/distill mix
    queue_len: int = 20  # B

    # autoencoder
    embed_dim: int = 32
    seed: int = 0

    # network simulation (repro_torch.sim): name of a registered scenario,
    # or "" for the plain (round-counted, no simulated clock) execution path
    scenario: str = ""
