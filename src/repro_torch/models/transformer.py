"""Transformer assembly for the LM serving and training paths.

Counterpart of ``repro.models.transformer`` for the block kinds the port
runs: ``attn`` (GQA + MLP), ``local_attn`` (the same over a sliding
window, with its own RoPE base), ``moe`` (GQA + a routed mixture of
experts, ``models.moe``), ``mla`` (DeepSeek's multi-head latent attention
+ an MLP of ``dense_d_ff``), ``mla_moe`` (MLA + the mixture of experts),
``rwkv6`` (time-mix + channel-mix), ``mamba2`` (a pre-norm Mamba2 mixer)
and ``shared_attn`` (zamba2's attention + MLP block, one parameter copy,
``params["shared"]["shared_attn"]``, used at each of its occurrences in
the repeated unit, each occurrence with its own KV cache slot). An
``ArchConfig`` describes the model as ``head_blocks + pattern*n_repeats +
tail_blocks``. The repeated unit keeps the reference's stacked layout (each
``params["unit"]`` leaf has a leading ``n_repeats`` axis), and
``_backbone`` loops over the repeats where the reference scans; with
``opts.remat`` the training forward recomputes each repeat in the backward
pass (``torch.utils.checkpoint``), where the reference wraps the scanned
unit in ``jax.checkpoint``.

whisper-small's encoder-decoder form runs as the reference's: with
``cfg.enc_dec`` every block has a cross attention half (``ln_x``,
``xattn``) over the encoder's states, which ``_encode`` computes from
``batch["frames"]`` (the stubbed audio frontend's output, bidirectional
attention layers stacked under ``params["encoder"]``) at prefill and in
training, and which decode reads from ``states["enc_out"]``;
``cfg.learned_pos_emb`` adds ``params["pos_embed"]`` rows to the token
embeddings (its start clamped as the reference's ``dynamic_slice`` clamps
it). llava-next-mistral-7b's ``vision_stub`` frontend prepends
``batch["media"]`` (the stubbed vision tower's patch embeddings) to the
token embeddings at prefill and in training; decode never sees media. A
frontend name other than the two stubs, or a block kind the reference
does not know, raises ``ValueError``.
``forward_train`` trains every kind and adds the ``moe`` and ``mla_moe``
blocks' router losses (``lb_loss``, ``router_z``, summed over the blocks)
to the LM loss, as the reference does. A shared block's one parameter
copy is used at each of its occurrences, inside the checkpointed repeats
too, so autograd sums its gradient over them, as ``jax.grad`` sums it
through the reference's scan, which closes over the copy. An MLA block's
cache is the compressed one (``c_kv`` and ``k_rope``, views of one buffer
per block occurrence, the unit's repeats stacked in it). A ``local_attn``
block's cache is as long as an ``attn`` block's, or with
``opts.window_cache`` as long as its window. The model runs on plain
tensors on one device, or on DTensors laid out over a mesh
(``launch.steps``): ``opts.act_spec`` then lays the residual stream out
before and after each repeat (the reference's ``_constrain``, for a
stream longer than one token) through ``sharding.specs.constrain``, which
returns a plain tensor as it is, and ``opts.moe_constrain`` runs the MoE
dispatch expert-parallel, its buffers on the expert axis (``models.moe``). An ``rwkv6``
block's time mix trains through ``ops.rwkv6_scan`` (the forward and backward kernels on the
card), or through the reference's chunk-parallel torch form with
``opts.rwkv_chunk``; ``opts.ssm_seq_chunk`` cuts a full-sequence block into
sequence chunks, each recomputed in the backward pass
(``torch.utils.checkpoint``), with the recurrent state carried from chunk
to chunk, as the reference's chunked-remat time scan; ``mamba2`` blocks
take the same chunking (their two conv states and the SSM state carried),
and train through ``ssm.mamba2_scan_chunked`` under autograd.

Entry points:
  init_params(cfg, opts, seed=, device=)      -> param tree
  forward_train(cfg, opts, params, batch)     -> (loss, {"ce", "lb_loss", "router_z"})
  forward_prefill(cfg, opts, params, batch)   -> last-position logits
  forward_decode(cfg, opts, params, batch, states) -> (logits, states)
  init_cache(cfg, opts, B, S, dtype, device=) -> decode state tree

Decode states are updated in place: ``forward_decode`` writes each block's
new KV entry or recurrent state into ``states`` and returns the same tree
(the reference returns a new one with the same values), so a 4096-long
cache is never copied. ``batch["pos"]`` is a Python int.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.sharding.specs import constrain
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_init,
    embed_lookup,
    init_mlp,
    init_norm,
    mask_padded_logits,
    mm,
    padded_vocab,
    split_heads,
    whole_inner,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PORTED_KINDS = ("attn", "local_attn", "moe", "mla", "mla_moe", "rwkv6", "mamba2",
                "shared_attn")
ATTN_KINDS = ("attn", "local_attn", "moe", "shared_attn")  # a GQA half and a KV cache
MLA_KINDS = ("mla", "mla_moe")  # an MLA half and a compressed cache
SSM_KINDS = ("rwkv6", "mamba2")  # a recurrent state
FRONTENDS = (None, "", "vision_stub", "audio_stub")  # stubs: the batch carries their output


@dataclass(frozen=True)
class ModelOpts:
    """Build/runtime options orthogonal to the architecture definition:
    the reference's fields, with the reference's defaults, but
    ``unroll_scan`` (the port loops over the repeats in Python always)."""

    kv_mult: int = 1  # KV-head replication for tensor parallelism
    expert_pad_to: int = 1  # pad routed experts to a multiple of this
    attn_chunk: int = 0  # online-softmax KV chunk of the training attention (0 = one block)
    rwkv_chunk: int = 0  # chunk-parallel RWKV6 (0 = exact scan)
    remat: bool = True  # activation checkpointing around each repeat (training)
    loss_chunk: int = 512  # sequence chunk for the LM loss (avoids (B,S,V))
    use_kernels: bool = False  # LM loss through ops.fused_softmax_xent
    ssm_seq_chunk: int = 0  # chunked-remat SSM time scan (0 = one full scan)
    window_cache: bool = False  # local_attn caches sized min(seq, sliding_window)
    # the reference's layouts over a mesh: the residual stream's spec between
    # repeats (seq parallel) and expert-sharded MoE dispatch buffers, set by
    # ``default_opts`` as the reference's; on plain tensors they do nothing
    act_spec: Any = None
    moe_constrain: bool = False


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown block kind {kind!r}; the block kinds are {PORTED_KINDS}")


def _check_ported(cfg) -> None:
    for blk in cfg.blocks:
        if blk.kind not in PORTED_KINDS:
            raise _unknown(blk.kind)
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"unknown frontend {cfg.frontend!r}; the frontends are "
                         f"{FRONTENDS[2:]} (or none)")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg, kind: str, opts: ModelOpts, *,
               cross: bool = False):
    """One block's parameters; a ``shared_attn`` block has an ``attn``
    block's. ``cross`` adds a cross attention half (``ln_x``, ``xattn``) to
    an attention block, as the reference does to every decoder block of an
    encoder-decoder model."""
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    if kind in ATTN_KINDS or kind in MLA_KINDS:
        mla = kind in MLA_KINDS
        p = {
            "ln1": init_norm(cfg, d, gen.device),
            **({"mla": A.init_mla(gen, cfg, dt)} if mla
               else {"attn": A.init_attn(gen, cfg, dt, opts.kv_mult)}),
            "ln2": init_norm(cfg, d, gen.device),
        }
        if kind in ("moe", "mla_moe"):
            p["moe"] = M.init_moe(gen, cfg, dt, opts.expert_pad_to)
        else:
            p["mlp"] = init_mlp(gen, cfg, d, (cfg.dense_d_ff or cfg.d_ff) if mla else cfg.d_ff,
                                dt)
        if cross:
            p["ln_x"] = init_norm(cfg, d, gen.device)
            p["xattn"] = A.init_cross_attn(gen, cfg, dt)
        return p
    if kind == "rwkv6":
        return {
            "ln1": init_norm(cfg, d, gen.device),
            "rwkv": S.init_rwkv6(gen, cfg, dt),
            "ln2": init_norm(cfg, d, gen.device),
        }
    if kind == "mamba2":
        return {"ln1": init_norm(cfg, d, gen.device), "mamba": S.init_mamba2(gen, cfg, dt)}
    raise _unknown(kind)


def init_block_state(cfg, kind: str, opts: ModelOpts, batch: int, seq: int, dtype,
                     device=None, lead: tuple = ()):
    """Decode-time state for one block occurrence: a ``seq``-long KV cache
    for every attention kind (``shared_attn`` included; ``local_attn`` too,
    but with ``opts.window_cache`` it is min(seq, sliding_window) long, the
    decode write clamped to its last slot as the reference's
    ``dynamic_update_slice`` clamps it), the compressed cache for the MLA
    kinds, the fp32 recurrent state of an SSM kind (whatever ``dtype``, as
    the reference's). ``lead`` stacks that many occurrences (a unit's
    repeats) on leading axes of each leaf."""
    if kind in MLA_KINDS:
        return A.init_mla_cache(cfg, batch, seq, dtype, device, lead)
    if lead:
        return tree_map(lambda t: t.new_zeros(tuple(lead) + t.shape),
                        init_block_state(cfg, kind, opts, batch, seq, dtype, device))
    if kind == "local_attn" and opts.window_cache:
        seq = min(seq, cfg.sliding_window)
    if kind in ATTN_KINDS:
        return A.init_kv_cache(cfg, batch, seq, dtype, opts.kv_mult, device)
    if kind == "rwkv6":
        return S.init_rwkv6_state(cfg, batch, device=device)
    if kind == "mamba2":
        return S.init_mamba2_state(cfg, batch, device=device)
    raise _unknown(kind)


def apply_block(cfg, opts: ModelOpts, kind: str, p, x, *, positions, state=None,
                cache_pos=None, enc_out=None, train: bool = False):
    """Returns (x, new_state, aux). state is None in prefill and training
    (full-sequence) mode; ``train`` selects the training attention
    (``attention.mha`` under autograd) over the forward-only kernel. A
    block with ``xattn`` adds its cross attention over ``enc_out`` between
    the attention half and the MLP half. aux is a ``moe`` or ``mla_moe``
    block's router losses {"lb_loss", "router_z"}, and None for the other
    kinds (the reference adds zeros for them)."""
    decode = state is not None and cache_pos is not None
    # a DTensor stream enters a block with its sequence whole: act_spec
    # shards it between repeats only (the gather before a column-parallel
    # product, as sequence parallelism does)
    x = whole_inner(x)
    if kind in ATTN_KINDS or kind in MLA_KINDS:
        h = apply_norm(cfg, p["ln1"], x)
        if kind in MLA_KINDS:
            y, new_state = A.mla_forward(
                cfg, p["mla"], h, positions=positions, theta=cfg.rope_theta,
                cache=state if decode else None, cache_pos=cache_pos, chunk=opts.attn_chunk,
                train=train)
        else:
            if kind == "local_attn":
                window, theta = cfg.sliding_window, cfg.local_rope_theta or cfg.rope_theta
            else:
                window, theta = 0, cfg.rope_theta
            y, new_state = A.attn_forward(
                cfg, p["attn"], h, positions=positions, theta=theta, window=window,
                cache=state if decode else None, cache_pos=cache_pos, chunk=opts.attn_chunk,
                kv_mult=opts.kv_mult, train=train)
        x = x + y
        if enc_out is not None and "xattn" in p:
            h = apply_norm(cfg, p["ln_x"], x)
            x = x + A.cross_attn_forward(cfg, p["xattn"], h, enc_out, train=train)
        h = apply_norm(cfg, p["ln2"], x)
        if kind in ("moe", "mla_moe"):
            y, aux = M.moe_forward(cfg, p["moe"], h, constrain=opts.moe_constrain)
        else:
            y, aux = apply_mlp(cfg, p["mlp"], h), None
        return x + y, new_state if decode else None, aux
    if kind in SSM_KINDS:
        init_state = S.init_rwkv6_state if kind == "rwkv6" else S.init_mamba2_state
        st0 = state if state is not None else init_state(cfg, x.shape[0], device=x.device)

        def block1(xc, st):
            h = apply_norm(cfg, p["ln1"], xc)
            if kind == "mamba2":
                y, st2 = S.mamba2_block(cfg, p["mamba"], h, st)
                return xc + y, st2
            n = xc.shape[1]
            if opts.rwkv_chunk and n % opts.rwkv_chunk == 0 and n > 1:
                y, st_tm = S.rwkv6_time_mix_chunked(cfg, p["rwkv"], h, st, opts.rwkv_chunk)
            else:
                y, st_tm = S.rwkv6_time_mix(cfg, p["rwkv"], h, st)
            xc = xc + y
            h = apply_norm(cfg, p["ln2"], xc)
            y, st_cm = S.rwkv6_channel_mix(cfg, p["rwkv"], h, st)
            return xc + y, {**st, **st_tm, **st_cm}

        C = opts.ssm_seq_chunk
        n = x.shape[1]
        if C and n > C and n % C == 0 and state is None:
            # chunked-remat time scan: each sequence chunk is recomputed in
            # the backward pass, so only the states between chunks are kept
            st, outs = st0, []
            for xc in x.split(C, dim=1):
                xo, st = checkpoint(block1, xc, st, use_reentrant=False)
                outs.append(xo)
            return torch.cat(outs, dim=1), None, None
        x, ns = block1(x, st0)
        return x, (ns if state is not None else None), None
    raise _unknown(kind)


# ---------------------------------------------------------------------------
# whole-model init
# ---------------------------------------------------------------------------


def init_params(cfg, opts: ModelOpts, *, seed: int = 0, device="cuda"):
    """Parameters drawn from one ``torch.Generator`` on ``device`` (seeded
    with ``seed``), so a large model is made on the card and never passes
    through the host. The tree layout is the reference's; the values differ
    from the reference's (another generator), so parity tests convert the
    reference's parameters with ``repro_torch.convert.lm_from_jax``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = _dtype(cfg.param_dtype)
    V = padded_vocab(cfg.vocab_size)
    d, cross = cfg.d_model, cfg.enc_dec
    params: dict[str, Any] = {
        "embed": embed_init(gen, V, d, dt),
        "final_norm": init_norm(cfg, d, dev),
    }
    if not cfg.tie_embeddings:
        params["out"] = embed_init(gen, V, d, dt)  # (V, d), used transposed
    if cfg.learned_pos_emb:
        params["pos_embed"] = embed_init(gen, cfg.max_seq_len, d, dt)
    params["head_blocks"] = [init_block(gen, cfg, b.kind, opts, cross=cross)
                             for b in cfg.head_blocks]
    params["tail_blocks"] = [init_block(gen, cfg, b.kind, opts, cross=cross)
                             for b in cfg.tail_blocks]
    # one copy per distinct shared kind of the pattern; the unit's stacked
    # leaves skip the shared positions
    params["shared"] = {}
    for b in cfg.pattern:
        if b.shared and b.kind not in params["shared"]:
            params["shared"][b.kind] = init_block(gen, cfg, b.kind, opts, cross=cross)
    params["unit"] = _stack_repeats(
        cfg.n_repeats,
        lambda: {f"blk{i}": init_block(gen, cfg, b.kind, opts, cross=cross)
                 for i, b in enumerate(cfg.pattern) if not b.shared})
    if cfg.enc_dec:
        # the encoder: enc_layers attention blocks without cross attention,
        # stacked on a leading axis as the reference stacks them for its scan
        params["encoder"] = _stack_repeats(cfg.enc_layers,
                                           lambda: init_block(gen, cfg, "attn", opts))
        params["enc_pos"] = embed_init(gen, cfg.enc_seq_len, d, dt)
        params["enc_norm"] = init_norm(cfg, d, dev)
    return params


def _stack_repeats(n: int, make) -> dict:
    """``n`` trees from ``make()`` stacked leafwise on a new leading axis,
    filled one repeat at a time (no list of n trees is held)."""
    if not n:
        return {}
    first = make()
    out = tree_map(lambda t: t.new_empty((n,) + t.shape), first)
    tree_map(lambda o, t: o[0].copy_(t), out, first)
    for r in range(1, n):
        tree_map(lambda o, t: o[r].copy_(t), out, make())
    return out


# ---------------------------------------------------------------------------
# encoder (bidirectional, whisper)
# ---------------------------------------------------------------------------


def _encode(cfg, opts, params, frames, *, train: bool = False):
    """frames: (B, Se, d), the stubbed conv / mel frontend's output. The
    reference's encoder: ``enc_pos`` rows added, then each stacked layer is
    pre-norm attention without RoPE or QK-norm, every frame seeing every
    frame (``ops.flash_attention(causal=False)``, or ``mha`` under
    ``train``), and the MLP; then ``enc_norm``."""
    B, Se, _ = frames.shape
    n, hd = cfg.num_heads, cfg.head_dim
    x = frames + params["enc_pos"][None, :Se].to(frames.dtype)
    positions = torch.arange(Se, device=x.device)
    layers = [t.unbind(0) for t in tree_leaves(params["encoder"])]
    for r in range(cfg.enc_layers):
        lp = tree_unflatten(params["encoder"], [ts[r] for ts in layers])
        h = apply_norm(cfg, lp["ln1"], x)
        q = split_heads(mm(h, lp["attn"]["wq"]), n, hd)
        k = split_heads(mm(h, lp["attn"]["wk"]), lp["attn"]["wk"].shape[-1] // hd, hd)
        v = split_heads(mm(h, lp["attn"]["wv"]), lp["attn"]["wv"].shape[-1] // hd, hd)
        if train:
            o = A.mha(q, k, v, q_positions=positions, k_positions=positions, causal=False)
        else:
            o = ops.flash_attention(q, k, v, causal=False, q_offset=0)
        x = x + mm(o.reshape(B, Se, n * hd), lp["attn"]["wo"])
        h = apply_norm(cfg, lp["ln2"], x)
        x = x + apply_mlp(cfg, lp["mlp"], h)
    return apply_norm(cfg, params["enc_norm"], x)


# ---------------------------------------------------------------------------
# backbone
# ---------------------------------------------------------------------------


def _write_state(dst: dict, new: dict) -> None:
    """Write a block's new state into its slot of the state tree in place."""
    for k, t in new.items():
        if t is not dst[k]:
            dst[k].copy_(t)


def _add_aux(total, aux):
    """The running router-loss sums plus one block's (None adds nothing)."""
    return total if aux is None else {k: total[k] + aux[k] for k in total}


def _backbone(cfg, opts, params, x, *, positions, states=None, cache_pos=None,
              enc_out=None, train: bool = False):
    """Run head blocks, the repeated unit, and tail blocks.

    states: None (prefill, training) or {"head": [..], "unit": stacked,
    "tail": [..]}, updated in place. ``enc_out``: the encoder's states,
    which every block with cross attention reads. ``train``: the training forward, whose
    repeats are checkpointed when ``opts.remat``. Returns the final-normed
    hidden states and the router losses {"lb_loss", "router_z"} summed over
    the blocks in layer order (fp32; 0 without a ``moe`` block)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "router_z": zero}
    for i, blk in enumerate(cfg.head_blocks):
        st = states["head"][i] if states else None
        x, ns, a = apply_block(cfg, opts, blk.kind, params["head_blocks"][i], x,
                               positions=positions, state=st, cache_pos=cache_pos,
                               enc_out=enc_out, train=train)
        aux = _add_aux(aux, a)
        if ns is not None:
            _write_state(st, ns)

    # each stacked leaf split into its repeats once: under autograd the
    # backward of one unbind is one stack, where indexing t[r] per repeat
    # would add a zero-filled gradient of the whole stack per repeat
    split = [t.unbind(0) for t in tree_leaves(params["unit"])]
    unit = [tree_unflatten(params["unit"], [ts[r] for ts in split])
            for r in range(cfg.n_repeats)]

    def lay_out(x):
        # the reference's _constrain: the residual stream of a sequence
        # (not of one decode token) laid out by act_spec
        return constrain(x, opts.act_spec) if x.shape[1] > 1 else x

    def repeat(x, aux, r):
        # the running sums go through the repeat (as the reference's scan
        # carries them), so a checkpointed repeat adds its blocks' losses
        # once, and their gradient reaches the router
        x = lay_out(x)
        for i, blk in enumerate(cfg.pattern):
            # a shared block's one copy, and this occurrence's own cache slot
            p = params["shared"][blk.kind] if blk.shared else unit[r][f"blk{i}"]
            st = tree_map(lambda t: t[r], states["unit"][f"blk{i}"]) if states else None
            x, ns, a = apply_block(cfg, opts, blk.kind, p, x, positions=positions, state=st,
                                   cache_pos=cache_pos, enc_out=enc_out, train=train)
            aux = _add_aux(aux, a)
            if ns is not None:
                _write_state(st, ns)
        return lay_out(x), aux

    for r in range(cfg.n_repeats):
        if train and opts.remat:
            x, aux = checkpoint(repeat, x, aux, r, use_reentrant=False)
        else:
            x, aux = repeat(x, aux, r)
    for i, blk in enumerate(cfg.tail_blocks):
        st = states["tail"][i] if states else None
        x, ns, a = apply_block(cfg, opts, blk.kind, params["tail_blocks"][i], x,
                               positions=positions, state=st, cache_pos=cache_pos,
                               enc_out=enc_out, train=train)
        aux = _add_aux(aux, a)
        if ns is not None:
            _write_state(st, ns)
    return apply_norm(cfg, params["final_norm"], x), aux


def _logits_matrix(cfg, params):
    return params["embed"] if cfg.tie_embeddings else params["out"]  # (V_pad, d)


def _embed_tokens(cfg, params, tokens, *, offset: int = 0):
    """Token embeddings, plus ``pos_embed`` rows from ``offset`` on with
    learned position embeddings. As the reference's
    ``dynamic_slice_in_dim``, the start is clamped to [0, max_seq_len - S],
    so the rows past the table repeat its last S."""
    x = embed_lookup(params["embed"], tokens)
    if cfg.learned_pos_emb:
        S = tokens.shape[1]
        start = max(0, min(int(offset), params["pos_embed"].shape[0] - S))
        x = x + params["pos_embed"][start:start + S][None].to(x.dtype)
    return x


def _inputs(cfg, opts, params, batch, train: bool = False):
    """The embedded sequence of a prefill or training batch, with the media
    prefix (``vision_stub``, when ``batch`` has ``media``) in front of the
    tokens, and the encoder's states (``enc_dec``, from ``batch["frames"]``)
    or None."""
    x = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.frontend == "vision_stub" and "media" in batch:
        x = torch.cat([batch["media"].to(x.dtype), x], dim=1)
    enc_out = _encode(cfg, opts, params, batch["frames"], train=train) if cfg.enc_dec else None
    return x, enc_out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def lm_loss_chunked(cfg, opts, h, w_vocab, labels):
    """Next-token CE without materializing (B, S, V). h: (B, S, d) hidden
    states (already shifted alignment: predict labels[t] from h[t]).

    The sequence goes in chunks of ``opts.loss_chunk`` (cut down to a
    divisor of S), a loop where the reference scans. ``opts.use_kernels``:
    logits in the compute dtype through ``ops.fused_softmax_xent`` (on the
    card ``distill_loss``'s cross-entropy entry, which takes no teacher,
    forward and backward, one launch each per chunk); otherwise fp32
    logits, logsumexp minus the gold logit.
    Returns the mean over B * S tokens, fp32."""
    B, Sq, d = h.shape
    h = whole_inner(h)  # a DTensor's sequence whole, to cut into chunks
    chunk = min(opts.loss_chunk, Sq)
    while Sq % chunk:
        chunk -= 1
    hc = h.reshape(B, Sq // chunk, chunk, d)
    lc = labels.reshape(B, Sq // chunk, chunk)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(Sq // chunk):
        h_i, l_i = hc[:, i], lc[:, i]
        logits = mm(h_i, w_vocab.T.to(h_i.dtype))
        if opts.use_kernels:
            logits = mask_padded_logits(logits, cfg.vocab_size)
            loss = ops.fused_softmax_xent(logits.reshape(-1, logits.shape[-1]),
                                          l_i.reshape(-1))
            total = total + loss.sum()
        else:
            logits = mask_padded_logits(logits.to(torch.float32), cfg.vocab_size)
            if ops.mesh_of(logits) is not None:
                logz, gold = _vocab_parallel_terms(logits, l_i)
            else:
                logz = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, l_i.long()[..., None])[..., 0]
            total = total + (logz - gold).sum()
    return total / (B * Sq)


def _vocab_parallel_terms(logits, labels):
    """logsumexp and the gold logit of DTensor logits whose vocabulary may be
    sharded over "model", each row flattened: the rows' max, then the sum of
    exponentials, each a partial result that one all-reduce over the
    vocabulary's shards completes, and the gold logit from the shard that
    holds it (DTensor's masked gather), so the (rows, V) logits are never
    gathered onto one device."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    V = logits.shape[-1]
    z = logits.reshape(-1, V)
    mesh = z.device_mesh
    zp = [Replicate() if p.is_partial() else p for p in z.placements]
    z = z.redistribute(mesh, zp)
    m = torch.amax(z.detach(), dim=-1, keepdim=True)
    logz = m[:, 0] + torch.log(torch.sum(torch.exp(z - m), dim=-1))
    vocab_dims = [i for i, p in enumerate(zp) if p == Shard(1)]
    if len(vocab_dims) > 1:
        raise NotImplementedError("the vocabulary is sharded over more than one mesh axis")
    width = -(-V // mesh.shape[vocab_dims[0]]) if vocab_dims else V
    rank = mesh.get_local_rank(vocab_dims[0]) if vocab_dims else 0

    def gold_of_shard(z, y):
        # the gold logit where this shard holds it, 0 elsewhere
        idx = y.long() - rank * width
        held = (idx >= 0) & (idx < z.shape[-1])
        g = torch.gather(z, -1, idx.clamp(0, z.shape[-1] - 1)[:, None])[:, 0]
        return torch.where(held, g, torch.zeros((), dtype=g.dtype, device=g.device))

    yp = [Replicate() if p == Shard(1) else p for p in zp]
    gp = [Partial() if p == Shard(1) else p for p in zp]
    labels = labels.reshape(-1)
    if ops.mesh_of(labels) is None:
        from torch.distributed.tensor import DTensor

        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    gold = local_map(gold_of_shard, out_placements=gp, in_placements=(zp, yp),
                     device_mesh=mesh)(z, labels.redistribute(mesh, yp))
    return logz, gold


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward_train(cfg, opts, params, batch):
    """batch: tokens (B, S) int, labels (B, S) int, and media (B, M, d)
    (``vision_stub``) or frames (B, Se, d) (``enc_dec``) where the config
    takes them; only the text positions carry labels. Returns the scalar
    training loss, ce + router_aux_weight * (lb_loss + 0.1 * router_z), and
    {"ce", "lb_loss", "router_z"} (the router terms summed over the ``moe``
    blocks; 0 in a model without one). Attention runs ``attention.mha``
    under autograd, the RWKV6 scan ``ops.rwkv6_scan`` (its kernels forward
    and backward on the card), the mamba2 scan its chunked torch form; each
    repeat is checkpointed with ``opts.remat``. A shared block's gradient
    is the sum over its occurrences. A block kind the reference does not
    know raises ``ValueError``."""
    _check_ported(cfg)
    x, enc_out = _inputs(cfg, opts, params, batch, train=True)
    positions = torch.arange(x.shape[1], device=x.device)
    h, aux = _backbone(cfg, opts, params, x, positions=positions, enc_out=enc_out, train=True)
    h = h[:, x.shape[1] - batch["tokens"].shape[1]:]  # the text positions
    loss = lm_loss_chunked(cfg, opts, h, _logits_matrix(cfg, params), batch["labels"])
    total = loss + cfg.router_aux_weight * (aux["lb_loss"] + 0.1 * aux["router_z"])
    return total, {"ce": loss, **aux}


def forward_prefill(cfg, opts, params, batch):
    """Full-sequence forward returning last-position logits (B, V_pad).
    batch: tokens (B, S) int, and media (B, M, d) or frames (B, Se, d) as
    ``forward_train`` takes them; positions run over media and text."""
    _check_ported(cfg)
    x, enc_out = _inputs(cfg, opts, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    h, _ = _backbone(cfg, opts, params, x, positions=positions, enc_out=enc_out)
    logits = mm(h[:, -1], _logits_matrix(cfg, params).T.to(h.dtype))
    return mask_padded_logits(logits, cfg.vocab_size)


def forward_decode(cfg, opts, params, batch, states):
    """One-token decode against a cache.

    batch: token (B, 1) int, pos (Python int) — the write/attend position.
    states: tree from ``init_cache`` (possibly filled), updated in place;
    an encoder-decoder model's cross attention reads ``states["enc_out"]``
    and leaves it as it is.
    Returns (logits (B, V_pad), states).
    """
    _check_ported(cfg)
    token, pos = batch["token"], int(batch["pos"])
    x = _embed_tokens(cfg, params, token, offset=pos)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    h, _ = _backbone(cfg, opts, params, x, positions=positions, states=states,
                     cache_pos=pos, enc_out=states.get("enc_out"))
    logits = mm(h[:, -1], _logits_matrix(cfg, params).T.to(h.dtype))
    return mask_padded_logits(logits, cfg.vocab_size), states


def init_cache(cfg, opts: ModelOpts, batch: int, seq: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """Zeroed decode states: KV caches (B, seq, K, H) in ``dtype`` for
    attention blocks (every attention kind), compressed caches (B, seq,
    lora) and (B, seq, rope_dim) in ``dtype`` for MLA blocks, fp32-state
    RWKV6 recurrences; unit states stacked over the repeats; for an
    encoder-decoder model ``enc_out`` (B, enc_seq_len, d) zeros in
    ``dtype``, which the caller fills with the encoder's states."""
    _check_ported(cfg)
    dev = resolve_device(device)

    def one(kind, lead=()):
        return init_block_state(cfg, kind, opts, batch, seq, dtype, dev, lead)

    states: dict[str, Any] = {
        "head": [one(b.kind) for b in cfg.head_blocks],
        "tail": [one(b.kind) for b in cfg.tail_blocks],
    }
    if cfg.n_repeats:
        states["unit"] = {f"blk{i}": one(b.kind, (cfg.n_repeats,))
                          for i, b in enumerate(cfg.pattern)}
    else:
        states["unit"] = None
    if cfg.enc_dec:
        states["enc_out"] = torch.zeros((batch, cfg.enc_seq_len, cfg.d_model), dtype=dtype,
                                        device=dev)
    return states

