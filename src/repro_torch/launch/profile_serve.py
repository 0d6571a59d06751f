"""Where a serving decode step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch llama3.2-3b]

For each architecture (every one the port serves, unless ``--arch`` names
some) it builds the full model in bf16 on the card, random weights from a
seed, one model at a time, with the serving shapes of ``chip_smoke.py``: 8 requests against a
4096-long cache, filled by 64 decode-step prefill positions (whisper-small's
encoder states random, as ``launch.serve`` draws them). It then runs
``--steps`` greedy decode steps without the profiler and as many under
``torch.profiler``, and reports: milliseconds per step, the device's busy
time per step (the union of kernel intervals) and idle share, kernels
launched per step, and the kernels that take the most device time. The
profiler slows the host, so the idle share is also given against the
unprofiled steps' wall time.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.fl.profile_round import TOP, busy_us

ARCHS = ("llama3.2-3b", "rwkv6-1.6b", "gemma3-12b", "nemotron-4-15b", "qwen2-moe-a2.7b",
         "llama3-8b", "deepseek-v2-lite-16b", "zamba2-7b", "whisper-small",
         "llava-next-mistral-7b")


def profile_decode(arch: str, *, requests: int = 8, prompt_len: int = 64,
                   cache_len: int = 4096, steps: int = 32, seed: int = 0,
                   device="cuda") -> dict:
    import gc

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import fill_enc_out
    from repro_torch.launch.steps import default_opts, make_serve_step
    from repro_torch.models.transformer import init_cache, init_params

    dev = resolve_device(device)
    cfg = get_arch(arch)
    opts = default_opts(cfg)
    params = init_params(cfg, opts, seed=seed, device=dev)
    step = make_serve_step(cfg, opts)
    cache = init_cache(cfg, opts, requests, cache_len, getattr(torch, cfg.compute_dtype),
                       device=dev)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (requests, prompt_len))).to(dev)
    if cfg.enc_dec:
        fill_enc_out(cfg, cache, rng)
    tok = None
    for t in range(prompt_len):
        tok, _, cache = step(params, cache, {"token": prompts[:, t:t + 1], "pos": t})
    pos = prompt_len

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def decode(n: int) -> float:
        nonlocal tok, cache, pos
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            tok, _, cache = step(params, cache, {"token": tok[:, None].long(), "pos": pos})
            pos += 1
        sync()
        return (time.perf_counter() - t0) / n

    if pos + 2 * steps > cache_len:
        raise ValueError(f"{prompt_len} + 2 x {steps} steps exceed the cache of {cache_len}")
    step_plain = decode(steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_prof = decode(steps)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device activity")
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6 / steps
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())

    print(f"== {arch}: {cfg.num_layers} layers, bf16, {requests} requests, cache {cache_len}, "
          f"decode positions {prompt_len}..{pos - 1}")
    print(f"ms per decode step: {1e3 * step_plain:.4f} unprofiled, {1e3 * step_prof:.4f} "
          f"profiled")
    print(f"device busy ms per step: {1e3 * busy:.4f}  idle share: "
          f"{1 - busy / step_plain:.4f} of the unprofiled step, "
          f"{1 - busy / step_prof:.4f} of the profiled one")
    print(f"kernels launched per step: {len(kernels) / steps:.1f}")
    print("top kernels by device time per step (ms, launches, mean us):")
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:TOP]:
        print(f"  {sum(ts) / 1e3 / steps:9.4f} ms  {len(ts) / steps:7.1f}  "
              f"{sum(ts) / len(ts):8.2f}  {name[:90]}")
    out = dict(ms_per_step=1e3 * step_plain, busy_ms_per_step=1e3 * busy,
               idle_share=1 - busy / step_plain, kernels_per_step=len(kernels) / steps)
    del params, cache, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, action="append")
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve measures the card: no CUDA device here")
    print(f"device: {torch.cuda.get_device_name(0)}")
    for arch in args.arch or ARCHS:
        profile_decode(arch, steps=args.steps)


if __name__ == "__main__":
    main()
