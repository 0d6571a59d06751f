"""Batched decode serving.

Counterpart of ``repro.launch.serve``. Serves a model with batched requests:
sequential cache build over the prompt (decode-step prefill: exact), then
batched greedy generation with the same ``serve_step``. Every attention
layer (``attn``, gemma3-12b's sliding-window ``local_attn``, the attention
half of qwen2-moe-a2.7b's ``moe`` blocks) runs the ``flash_attention``
kernel, every MLA layer of deepseek-v2-lite-16b (``mla``, ``mla_moe``)
the latent decode kernel over its compressed cache, every occurrence of
zamba2-7b's shared attention block the ``flash_attention`` kernel at head
dim 112 (its mamba2 blocks run torch ops: the reference's scan is XLA's,
no Pallas kernel), every RWKV6 time-mix the ``rwkv6_scan`` kernel, and
whisper-small's self and cross attention the ``flash_attention`` kernel at
head dim 64 on the card; ``--arch`` takes every architecture the port
registers. As in the reference, whisper-small's cache holds random encoder
states (``enc_out``, drawn with the prompts' generator after them; the
encoder does not run), and llava-next-mistral-7b serves text alone (decode
never sees media).

  python -m repro_torch.launch.serve --arch rwkv6-1.6b --requests 4 --gen 16
  python -m repro_torch.launch.serve --full            # llama3.2-3b, bf16

The CLI runs on the card by default; ``--device cpu`` (or
``serve(..., device="cpu")``) runs the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_arch, list_archs, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.steps import default_opts, make_serve_step
from repro_torch.models.transformer import init_cache, init_params


@dataclass
class ServeResult:
    tokens: np.ndarray  # (num_requests, gen_len) generated token ids
    prefill_s: float  # wall seconds of the decode-step prefill, ends in a sync
    gen_s: float  # wall seconds of the generation, ends in a sync
    logits_finite: bool  # every step's logits were finite

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / max(self.gen_s, 1e-9)

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.gen_s / max(self.tokens.shape[1], 1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fill_enc_out(cfg, cache: dict, rng: np.random.Generator) -> None:
    """Fill an encoder-decoder cache's ``enc_out`` with standard normal
    numbers from ``rng`` in the compute dtype, as the reference's ``serve``
    does in place of running the encoder."""
    e = rng.normal(0, 1, (cache["enc_out"].shape[0], cfg.enc_seq_len, cfg.d_model))
    cache["enc_out"].copy_(torch.from_numpy(e).to(getattr(torch, cfg.compute_dtype)))


def serve(arch: str | ArchConfig, *, num_requests: int = 4, prompt_len: int = 16,
          gen_len: int = 16, cache_len: int = 64, seed: int = 0, use_reduced: bool = True,
          greedy: bool = True, device="cuda") -> ServeResult:
    """Serve ``num_requests`` random prompts of ``prompt_len`` tokens and
    generate ``gen_len`` more each, for ``arch`` (a registered name, reduced
    unless ``use_reduced=False``, or an ``ArchConfig`` taken as it is).
    Sampling is greedy (argmax) whatever ``greedy`` says, as in the
    reference."""
    dev = resolve_device(device)
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = reduced(get_arch(arch)) if use_reduced else get_arch(arch)
    if prompt_len < 1 or prompt_len + gen_len > cache_len:
        raise ValueError(f"need 1 <= prompt_len and prompt_len + gen_len <= cache_len "
                         f"({prompt_len} + {gen_len} > {cache_len})")
    opts = default_opts(cfg)
    params = init_params(cfg, opts, seed=seed, device=dev)
    serve_step = make_serve_step(cfg, opts)

    B = num_requests
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, (B, prompt_len)).astype(np.int32)
    prompts = torch.from_numpy(prompts).to(dev, torch.int64)
    cache = init_cache(cfg, opts, B, cache_len, getattr(torch, cfg.compute_dtype),
                       device=dev)
    if cfg.enc_dec:
        fill_enc_out(cfg, cache, rng)
    finite = torch.ones((), dtype=torch.bool, device=dev)

    # exact prefill via decode steps (cache build)
    _sync(dev)
    t0 = time.perf_counter()
    tok = None
    for t in range(prompt_len):
        tok, logits, cache = serve_step(params, cache,
                                        {"token": prompts[:, t:t + 1], "pos": t})
        finite &= torch.isfinite(logits).all()
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # batched generation; tokens stay on the device until the end
    out = []
    t0 = time.perf_counter()
    cur = tok[:, None].long()
    for t in range(prompt_len, prompt_len + gen_len):
        nxt, logits, cache = serve_step(params, cache, {"token": cur, "pos": t})
        finite &= torch.isfinite(logits).all()
        cur = nxt[:, None].long()
        out.append(nxt)
    _sync(dev)
    t_gen = time.perf_counter() - t0
    gen = (torch.stack(out, 1) if out else torch.zeros((B, 0), dtype=torch.int32))
    res = ServeResult(gen.cpu().numpy(), t_prefill, t_gen, bool(finite))
    print(f"[serve] {cfg.name} on {dev.type}: {B} requests, prefill {prompt_len} tok "
          f"({res.prefill_s:.3f}s), generated {gen_len} tok/req "
          f"({res.gen_s:.3f}s, {res.tokens_per_s:.1f} tok/s, "
          f"{res.ms_per_step:.3f} ms/step)")
    if not res.logits_finite:
        raise FloatingPointError(f"{cfg.name}: non-finite logits while serving")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve(args.arch, num_requests=args.requests, prompt_len=args.prompt,
                 gen_len=args.gen, cache_len=args.cache, use_reduced=not args.full,
                 device=args.device)


if __name__ == "__main__":
    main()
