"""Batched decode serving of a reduced assigned architecture, counterpart of
``examples/serve_decode.py``: ``launch.serve.serve`` of 4 requests, 8-token
prompts and 8 generated tokens each, against a 32-long cache.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [arch]
    PYTHONPATH=src python -m repro_torch.examples.serve_decode rwkv6-1.6b --device cpu
"""
from __future__ import annotations

import argparse

REQUESTS, PROMPT_LEN, GEN_LEN, CACHE_LEN = 4, 8, 8, 32


def main(argv=None):
    from repro_torch.configs import list_archs
    from repro_torch.launch.serve import serve

    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_decode")
    ap.add_argument("arch", nargs="?", choices=list_archs(), default="rwkv6-1.6b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve(args.arch, num_requests=REQUESTS, prompt_len=PROMPT_LEN, gen_len=GEN_LEN,
                 cache_len=CACHE_LEN, device=args.device)


if __name__ == "__main__":
    main()
