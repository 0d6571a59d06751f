"""Build, load and count the port's CUDA kernels.

The sources in ``repro_torch/csrc/*.cu`` expose a plain C interface. At
first use they are compiled for Hopper with ``nvcc`` — one process per
source, all started together, then one link — into a shared library under
``build/kernels/<hash of sources and flags>/`` at the repository root, and
loaded with ``ctypes``. A failed build raises with nvcc's output. Nothing
is compiled or loaded when this module is imported.

``launches`` counts kernel launches by name; a wrapper adds one where it
launches its kernel and nowhere else. A TPU kernel with two CUDA variants
keeps one name there; its wrapper keeps a per-variant count of its own,
registered with ``counter`` so that ``reset_launches`` zeroes it too.

On a ``meta`` tensor (``launch.dryrun``'s trace) a wrapper allocates what
its CUDA path allocates, outputs and scratch alike, on ``meta``, and
``launch`` calls ``meta_launch`` instead of the kernel: no
arithmetic, no count, and the kernel's FLOPs and scratch bytes go to the
sinks ``meta_sink`` installs (``FlopCounterMode`` cannot see inside a
hand-written kernel).

A kernel that checks its inputs reports a fault in pinned host words
(``fault_words``) that are read at the caller's next sync on the card
(``check_labels``' or ``raise_faults``), so that no launch waits for a
read-back of its own.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: dict[str, int] = {
    "distill_loss_fwd": 0, "distill_loss_bwd": 0, "skr_rectify": 0,
    "flash_attention": 0, "flash_attention_empty_rows": 0, "rwkv6_scan": 0,
    "rwkv6_scan_bwd": 0,
}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # z, t, y, loss, stats, rows, V, beta, lw, layout, threads, stream
    # (z, t fp32; _bf16: bf16); the CE entries (_ce) take no t and no beta
    "distill_loss_fwd": [_P, _P, _P, _P, _P, _LL, _I, _F, _F, _I, _I, _P],
    "distill_loss_fwd_bf16": [_P, _P, _P, _P, _P, _LL, _I, _F, _F, _I, _I, _P],
    "distill_loss_fwd_ce": [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _P],
    "distill_loss_fwd_ce_bf16": [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _P],
    # z, t, y, stats, g, dz, rows, V, beta, lw, threads, slices, stream
    # (z, t, dz fp32; _bf16: bf16); the CE entries (_ce) take no t and no beta
    "distill_loss_bwd": [_P, _P, _P, _P, _P, _P, _LL, _I, _F, _F, _I, _I, _P],
    "distill_loss_bwd_bf16": [_P, _P, _P, _P, _P, _P, _LL, _I, _F, _F, _I, _I, _P],
    "distill_loss_bwd_ce": [_P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _P],
    "distill_loss_bwd_ce_bf16": [_P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _P],
    # p, label, p_c, do, qbar, out, rows, C, stream
    "skr_rectify": [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
    # p, label, label_is_i64, q, count, head, out, q_out, count_out,
    # head_out, err, B, N, C, Bq, stream
    "skr_process": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, o, B, Sq, Sk, N, K, H, Hv, is_bf16, causal, window, q_offset,
    # k_len, scale, stream
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL,
                        _I, _F, _P],
    # q, k, v, o, B, Sq, Sk, N, K, H, Hv, causal, window, q_offset, k_len,
    # scale, stream (bf16 only)
    "flash_attention_sm90": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _I,
                             _F, _P],
    # H, Hv, regs out, local bytes out (no stream)
    "flash_attention_sm90_attrs": [_I, _I, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_longlong)],
    # H, Hv, is_bf16, regs out, local bytes out (no stream)
    "flash_attention_attrs": [_I, _I, _I, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_longlong)],
    # q, c_kv, k_rope, o, ws, B, S, N, c_kv batch and row strides, k_rope
    # batch and row strides (elements), is_bf16, q_offset, scale, chunk,
    # splits, vsplits, stream
    "flash_attention_latent_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _LL,
                                      _I, _LL, _F, _I, _I, _I, _P],
    # is_bf16, regs out, local bytes out (no stream)
    "flash_attention_latent_decode_attrs": [_I, ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_longlong)],
    # q, k, v, o, ws, B, Sk, N, K, H, is_bf16, causal, window, q_offset,
    # k_len, scale, chunk, splits, stream (Sq = 1)
    "flash_attention_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _LL,
                               _I, _F, _I, _I, _P],
    # v, o, B, Sq, Sk, N, K, H, is_bf16, causal, window, q_offset, stream
    "flash_attention_empty_rows": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    # r, k, v, w, u, s0, y, sT, B, T, H, hd, stream
    "rwkv6_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # r, k, v, w, u, s0, y, sT, st, rp, pend, B, T, H, hd, chunk, stream
    "rwkv6_scan_chunked": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P],
    # r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, dup, ds0, sx, gx, pend, B, T,
    # H, hd, chunk, stream
    "rwkv6_scan_bwd": [_P] * 17 + [_I, _I, _I, _I, _I, _P],
    # hd, chunk, shared memory bytes out (no stream)
    "rwkv6_scan_bwd_smem": [_I, _I, ctypes.POINTER(ctypes.c_longlong)],
}

_lib: ctypes.CDLL | None = None
_counters: list[dict[str, int]] = [launches]


def counter(keys) -> dict[str, int]:
    """A dict of launch counts at 0 that ``reset_launches`` also zeroes."""
    d = dict.fromkeys(keys, 0)
    _counters.append(d)
    return d


def reset_launches() -> None:
    for d in _counters:
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> tuple[Path, str]:
    """Compile the kernels unless this exact build exists; return the
    library's path and the ``-Xptxas -v`` report (registers, shared
    memory and spills per kernel)."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16]
    lib, log = out / LIB_NAME, out / "ptxas.log"
    if lib.exists() and log.exists():
        return lib, log.read_text()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(srcs, objs)
        ]
        reports = [(s, p, p.communicate()[0]) for s, p in zip(srcs, procs)]
        for s, p, text in reports:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{text}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        report = "".join(f"== {s.name}\n{text}" for s, _, text in reports)
        log.write_text(report)
        os.replace(tmp_lib, lib)
    return lib, report


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        path, _ = build()
        handle = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args, count_as: str | None = None,
           flops=None, scratch=()) -> None:
    """Call kernel entry point ``name`` on ``device``'s current stream
    (appended as the last argument), count the launch under ``count_as``
    (default ``name``) and raise if CUDA refused it. On the ``meta`` device
    nothing is built, launched or counted: ``meta_launch`` hears ``name``
    with ``flops()`` (a callable, so the card's path never evaluates it)
    and the ``scratch`` tensors."""
    if device.type == "meta":
        meta_launch(name, flops=flops() if flops is not None else 0.0, scratch=scratch)
        return
    fn = getattr(lib(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")
    launches[count_as or name] += 1


_meta_sinks: list = []


def meta_launch(name: str, *, flops: float, scratch=()) -> None:
    """What a launch of kernel ``name`` would do, on ``meta`` tensors: tell
    each sink of ``meta_sink`` its FLOPs and the bytes of its scratch
    tensors (allocated by the caller on ``meta``, as on the card, and freed
    when the wrapper returns). Counts no launch."""
    nbytes = sum(t.untyped_storage().nbytes() for t in scratch)
    for sink in _meta_sinks:
        sink(name, float(flops), nbytes)


@contextlib.contextmanager
def meta_sink(fn):
    """While open, ``fn(name, flops, scratch_bytes)`` hears every
    ``meta_launch``."""
    _meta_sinks.append(fn)
    try:
        yield fn
    finally:
        _meta_sinks.remove(fn)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a call to a kernel that has no
    backward (a launch through ``data_ptr`` leaves its output with no
    ``grad_fn``, so the gradient would be dropped without a word)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            "call it under torch.no_grad() (training attention runs "
            "repro_torch.models.attention.mha)")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def check_labels(name: str, labels: torch.Tensor, n: int) -> torch.Tensor:
    """Labels as int32 after checking they lie in [0, n). On a card the
    check reads one flag back to the host; that sync also reports the
    kernels' faults (``check_faults``)."""
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: labels must be int32 or int64, got {labels.dtype}")
    if labels.numel() and not labels.is_meta:  # a meta tensor has no values to check
        if not bool(((labels >= 0) & (labels < n)).all()):
            raise ValueError(f"{name}: labels must lie in [0, {n})")
        if labels.is_cuda:
            check_faults(labels.device)
    return labels.to(torch.int32).contiguous()


# Fault words: pinned host memory, mapped into the card's address space,
# that a kernel ORs fault bits into (over the bus, and only on a fault), so
# that no launch reads a flag back. They are read, and zeroed, at the next
# sync the caller makes anyway on the launches' stream (``check_labels``'s),
# or by ``raise_faults``, which makes one. Keyed by (kernel, device index);
# each entry holds the words and the function that turns set bits into the
# exception to raise.
_faults: dict[tuple[str, int], tuple[np.ndarray, torch.Tensor, object]] = {}


def fault_words(name: str, device: torch.device, n: int, report) -> torch.Tensor:
    """At least ``n`` int32 fault words for kernel ``name`` on ``device``,
    zero until a launch sets one; ``report(bits)`` gives the exception that
    a set word raises. Growing them first syncs ``device`` and reads the
    old ones."""
    if device.type == "meta":  # no launch sets them; the card keeps them in host memory
        return torch.empty(0, dtype=torch.int32, device=device)
    key = (name, device.index)
    held = _faults.get(key)
    if held is None or held[0].size < n:
        if held is not None:
            raise_faults(device)
        words = torch.zeros(max(n, 64), dtype=torch.int32, pin_memory=True)
        held = _faults[key] = (words.numpy(), words, report)
    return held[1]


def check_faults(device: torch.device) -> None:
    """Raise if a kernel on ``device`` set a fault word, and zero the words.
    Call it only after a sync that covers the launches' stream."""
    for (name, index), (words, _, report) in _faults.items():
        if index == device.index and words.any():
            bits = int(np.bitwise_or.reduce(words))
            words[:] = 0
            raise report(bits)


def raise_faults(device: torch.device | str = "cuda") -> None:
    """Wait for ``device``'s work, then ``check_faults``: for a caller that
    makes no sync of its own after a launch."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize(device)
    check_faults(device)
