"""Kernel contract analyzer: the Hopper kernels' contracts, checked without
a card.

Counterpart of ``repro.analysis.kernel_contracts``, which checks a mirror of
each Pallas kernel's block geometry against ``jax.eval_shape``. Here each
family of C entries in ``src/repro_torch/csrc`` has a :class:`KernelContract`:
its module, public entry, 2-D wrapper and ``autograd.Function``, its
``__global__`` functions and source, its contract shapes (the main paths'
full-width shapes, ``PERF.md`` section 6) and, for each compiled instance of
its kernels, a mirror of the source (:class:`Instance`: threads,
``__launch_bounds__``' minimum blocks, static and dynamic shared bytes, the
opt-in its launch site makes). The checks read source and trace on the
``meta`` device, as ``launch.dryrun`` does (the counterpart of
``jax.eval_shape``), so they need no card:

* **KRN001, entry contract**: each public entry, called on ``meta`` tensors
  at each contract shape, gives the contracted output shapes and dtypes and
  reaches only its family's C entries; each ``extern "C"`` declaration in
  ``csrc/*.cu``, read as argument kinds (pointer, int, long long, float,
  stream), agrees in count and order with ``_lib._SIGNATURES``, and every
  name on either side has its counterpart;
* **KRN002, dispatch coverage** (the counterpart of block divisibility):
  every head dim or (H, Hv) pair a config of ``repro_torch.configs`` uses
  has its instances, every rwkv6 head size is in ``rwkv6_scan.HEAD_DIMS``,
  the split plans keep to their kernels' rules, the plans' constants are
  the kernels', and every grid stays within CUDA's limits;
* **KRN003, resources against sm_90**: static shared memory within 48 KB,
  static plus dynamic within the limit (sm_90's opt-in, 227 KiB), the
  opt-in in the source of every kernel that needs it, and threads times
  minimum blocks within 2,048 a multiprocessor;
* **KRN004, fp32 accumulation**: every ``mma.sync`` and ``wgmma.mma_async``
  instruction has an f32 D, and a family marked as a tensor-core kernel
  has such an instruction;
* **KRN005, gradient pairing**: ``DistillLoss``, ``SoftmaxXent`` and
  ``Rwkv6Scan`` are ``torch.autograd.Function``s their entries apply, whose
  backward traces on ``meta`` to the inputs' shapes; the 2-D wrappers give
  the B = 1 slice of the batched entry; a forward-only kernel's wrapper
  refuses grad (``_lib.refuse_grad``).

Each failed check is a :class:`~repro_torch.analysis.findings.Finding` with
rule ID ``KRN001``-``KRN005``, in the same stream as the AST rules. Tests
corrupt a contract (``dataclasses.replace``, or a source string) and hold
that its check fails (``tests/test_torch_analysis.py``).

The mirror is held to the built kernels on the card by
:func:`card_attrs` (``cudaFuncGetAttributes`` through each family's
``*_attrs`` entry) and :func:`card_trace` (a contract shape through the
entry on the card against its meta trace): ``chip_smoke.py``'s static
analysis phase and ``tests/test_torch_gpu.py`` run them.
"""
from __future__ import annotations

import ctypes
import importlib
import inspect
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from repro_torch.analysis.findings import Finding

# sm_90 (H100): the dynamic shared memory a block may opt in to (227 KiB),
# the static shared memory a block may have (and the dynamic it may take
# without the opt-in), threads and registers a multiprocessor, registers a
# thread, threads a block, and a grid's dimensions
SMEM_OPTIN = 232_448
SMEM_STATIC = 48 * 1024
THREADS_PER_SM = 2048
REGS_PER_SM = 65_536
REGS_PER_THREAD = 255
THREADS_PER_BLOCK = 1024
GRID_LIMITS = (2**31 - 1, 65_535, 65_535)
DEFAULT_SMEM_LIMIT = SMEM_OPTIN

CSRC = Path(__file__).resolve().parent.parent / "csrc"
CSRC_REL = "src/repro_torch/csrc"

KRN_EXPLAIN = {
    "KRN001": "a kernel entry failed to trace on the meta device, gave shapes or dtypes "
              "outside its contract or reached another family's C entry, or an extern "
              "\"C\" declaration in csrc/*.cu disagrees with _lib._SIGNATURES (argument "
              "count, order or kind: pointer, int, long long, float, stream), or a name "
              "on one side has no counterpart: a dropped argument or an int where C "
              "takes long long corrupts memory on the card without a word",
    "KRN002": "dispatch coverage: a head dim or (H, Hv) pair a config uses has no "
              "kernel instance, an rwkv6 head size is not in rwkv6_scan.HEAD_DIMS, a "
              "split plan breaks its kernel's rules (chunk alignment, splits that "
              "cover the keys, LATENT_MAX_SPLITS / LATENT_MAX_VSPLITS), a plan's "
              "constant differs from its kernel's, or a grid passes CUDA's limits",
    "KRN003": "a kernel instance's resources pass sm_90's: static shared memory over "
              "48 KB, static plus dynamic over the limit (227 KiB), dynamic shared "
              "memory past 48 KB with no cudaFuncSetAttribute opt-in in its source, "
              "or threads x minimum blocks over 2,048 a multiprocessor",
    "KRN004": "a tensor-core product without fp32 accumulation: an mma.sync or "
              "wgmma.mma_async instruction whose D type is not f32, or a family "
              "marked as a tensor-core kernel with no such instruction",
    "KRN005": "gradient pairing is broken: a differentiable entry does not apply a "
              "torch.autograd.Function, or its backward does not trace on meta to "
              "the inputs' shapes; a 2-D wrapper's output is not the B = 1 slice of "
              "the batched entry; or a forward-only kernel's wrapper lets an input "
              "that requires grad through (its output would have no grad_fn)",
}


@dataclass(frozen=True)
class T:
    """A tensor argument of a contract call: its shape and dtype."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32


@dataclass(frozen=True)
class Instance:
    """One compiled instance of a ``__global__`` function, mirrored from
    its source."""

    kernel: str  # the __global__ function
    label: str  # its template arguments, as the source writes them
    attrs: tuple[int, ...]  # the arguments of the family's *_attrs entry that name it
    threads: int  # __launch_bounds__' threads, or its launch's where it has none
    min_blocks: int = 1  # __launch_bounds__' minimum blocks an SM
    static_smem: int = 0  # bytes of the __shared__ arrays its code reaches
    dynamic_smem: int = 0  # bytes of dynamic shared memory its launch passes
    opt_in: int | None = None  # bytes its launch site's cudaFuncSetAttribute sets
    spills: str | None = None  # why the card may give it local bytes

    @property
    def name(self) -> str:
        return f"{self.kernel}<{self.label}>" if self.label else self.kernel

    def reg_cap(self) -> int:
        """The registers a thread may have so that min_blocks blocks of
        ``threads`` fit a multiprocessor."""
        return min(REGS_PER_THREAD, REGS_PER_SM // (self.threads * self.min_blocks))


@dataclass(frozen=True)
class KernelContract:
    name: str
    module: str  # the wrapper's module
    entry: str  # the public (batched) entry
    source: str  # the file under csrc/
    c_entries: tuple[str, ...]  # the C entries its calls may reach
    attrs_entry: str  # its query entry (kernel_attrs.cuh's six numbers)
    kernels: tuple[str, ...]  # its __global__ functions
    instances: tuple[Instance, ...]
    shapes: tuple[dict, ...]  # the contract shapes
    inputs: Callable[[dict], tuple[tuple, dict]]  # shape -> (args, kwargs), tensors as T
    expect: Callable[[dict], tuple[T, ...]]  # shape -> the contracted outputs
    grids: Callable[[dict], list[tuple[str, tuple[int, ...], int]]]  # (kernel, grid, threads)
    wrapper: str | None = None  # the 2-D B = 1 wrapper
    function: str | None = None  # the torch.autograd.Function the entry applies
    grad: bool = False  # whether its backward is traced (inputs[0] requires grad)
    tensor_core: bool = False  # whether fp32 accumulation on the tensor cores applies

    def source_path(self) -> str:
        return "src/" + self.module.replace(".", "/") + ".py"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# The contract table: a mirror of the sources (held to the built kernels on
# the card by card_attrs, to the meta trace by KRN001)
# ---------------------------------------------------------------------------

F32, BF16, I32, I64 = torch.float32, torch.bfloat16, torch.int32, torch.int64
_DT = {F32: "float", BF16: "bf16"}


def _distill_instances(has_t: bool) -> tuple[Instance, ...]:
    """distill_loss.cu: fwd_regs (launch bounds kBlock = 256; red[5][8]
    floats, reached only through row_max / row_sum's TPR > 32 branch),
    fwd_stream (512; part[16] of 16-byte Online states), bwd (256)."""
    out = []
    for dtype in (F32, BF16):
        for vec in (True, False):
            args = f"{_DT[dtype]}, {has_t}, {vec}".lower()
            flags = (int(dtype == BF16), int(has_t), int(vec))
            for tpr in (32, 64, 128, 256):
                out.append(Instance("fwd_regs", f"{args}, {tpr}", (0, *flags, tpr), 256,
                                    static_smem=5 * 8 * 4 if tpr > 32 else 0))
            out.append(Instance("fwd_stream", args, (1, *flags, 0), 512,
                                static_smem=16 * 16))
            out.append(Instance("bwd", args, (2, *flags, 0), 256))
    return tuple(out)


def _sm90_smem(H: int, Hv: int) -> int:
    """flash_attention_sm90.cu's Cfg<H, HV>::SMEM: Q (128 rows) and two
    stages of K and V (64 keys) at rows rounded up to 64 bf16, + 1 KB to
    align; the (256, 256) instance's H256::SMEM: Q and two stages of K and V
    tiles, five barriers, + 1 KB."""
    if (H, Hv) == (256, 256):
        return 128 * 256 * 2 + 4 * 64 * 256 * 2 + 5 * 8 + 1024
    hp, hvp = _cdiv(H, 64) * 64, _cdiv(Hv, 64) * 64
    return 128 * hp * 2 + 2 * (64 * hp * 2 + 64 * hvp * 2) + 1024


def _sm90_instances() -> tuple[Instance, ...]:
    from repro_torch.kernels.flash_attention import SM90_INSTANCES

    out = []
    for H, Hv in SM90_INSTANCES:
        smem = _sm90_smem(H, Hv)
        if (H, Hv) == (256, 256):
            out.append(Instance("flash_sm90_h256_kernel", "", (H, Hv), 384, 1, 0, smem, smem))
        else:
            out.append(Instance("flash_sm90_kernel", f"{H}, {Hv}", (H, Hv), 256, 1, 0, smem,
                                smem))
    return tuple(out)


def _tf32x3_cfg(dtype: torch.dtype, H: int, Hv: int) -> dict:
    """flash_attention.cu's Cfg<T, H, HV>."""
    square_mid = H == Hv and H in (64, 128)
    warps = 8 if square_mid or H != Hv else 4
    bn = 64 if square_mid else 32
    vs = Hv + 4 if dtype == F32 else Hv + 8
    smem = 16 * warps * H * 4 + 2 * (bn * (H + 8) + bn * vs) * dtype.itemsize
    return {"threads": 32 * warps, "min_blocks": 4 if H == 32 else 1, "bm": 16 * warps,
            "smem": smem}


def _tf32x3_instances() -> tuple[Instance, ...]:
    from repro_torch.kernels.flash_attention import TF32X3_INSTANCES

    out = []
    for dtype in (F32, BF16):
        for H, Hv in TF32X3_INSTANCES:
            c = _tf32x3_cfg(dtype, H, Hv)
            spills = ("bf16 prefill at (256, 256) runs the sm90 instance: only a direct "
                      "launch reaches this one" if (dtype, H) == (BF16, 256) else None)
            out.append(Instance("flash_tf32x3_kernel", f"{_DT[dtype]}, {H}, {Hv}",
                                (H, Hv, int(dtype == BF16)), c["threads"], c["min_blocks"],
                                0, c["smem"], c["smem"], spills))
    return tuple(out)


DECODE_THREADS = 128  # flash_attention_decode.cu's kThreads: 4 warps
DECODE_GROUPS = (1, 2, 4, 8)  # its GT instances, q heads a block (kMaxRows = 8)


def _decode_gt(G: int) -> int:
    """The split kernel's GT for G q heads a kv head (by_group)."""
    return next(gt for gt in DECODE_GROUPS if G <= gt or gt == DECODE_GROUPS[-1])


def _decode_instances() -> tuple[Instance, ...]:
    """flash_attention_decode.cu: the split pass (sm_acc[4][GT][H] and
    sm_m, sm_l[4][GT] floats) and the merge pass, both 128 threads."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    out = []
    for dtype in (F32, BF16):
        for H in HEAD_DIMS:
            for gt in DECODE_GROUPS:
                spills = ("fp32 decode at head_dim 112 with 3-4 q heads a kv head: no config "
                          "has it (zamba2-7b's attention is MHA, G = 1)"
                          if (dtype, H, gt) == (F32, 112, 4) else None)
                out.append(Instance("flash_decode_split", f"{_DT[dtype]}, {H}, {gt}",
                                    (0, int(dtype == BF16), H, gt), DECODE_THREADS,
                                    static_smem=4 * (4 * gt * H + 2 * 4 * gt), spills=spills))
            out.append(Instance("flash_decode_merge", f"{_DT[dtype]}, {H}",
                                (1, int(dtype == BF16), H, 0), DECODE_THREADS))
    return tuple(out)


LATENT_THREADS = 256  # flash_attention_latent_decode.cu's kThreads
LATENT_MERGE_THREADS = 512 // 4  # kMergeThreads: 4 of the 512 value columns a thread


def _latent_smem() -> tuple[int, int]:
    """flash_attention_latent_decode.cu's wg::SMEM (two slots of 64 keys x
    576 bf16 in 64-column TMA boxes, q's and P's parts at 784-byte column
    groups, the partial scores, alphas, (m, l), two barriers, + 1 KB of
    swizzle alignment) and f32::SMEM (two stages of 32 rows of 584 floats,
    the warps' partial scores at a stride of 40, P's hi and lo fragments,
    alphas and (m, l))."""
    heads, d = 16, 576
    slot = (d // 64) * 64 * 128
    lbo = 6 * 128 + 16
    red = 2 * slot + (d // 8) * lbo + (64 // 8) * lbo
    wg = red + 2 * heads * 68 * 4 + heads * 4 + 2 * heads * 4 + 2 * 8 + 1024
    red32 = 2 * 32 * (d + 8) * 4
    f32 = red32 + 8 * heads * 40 * 4 + 2 * (32 // 8) * 32 * 4 * 4 + heads * 4 + 2 * heads * 4
    return wg, f32


def _latent_instances() -> tuple[Instance, ...]:
    wg, f32 = _latent_smem()
    out = [Instance("latent_decode_wgmma", str(mt), (0, mt), LATENT_THREADS, 1, 0, wg, wg)
           for mt in (4, 2, 1)]
    out.append(Instance("latent_decode_mma", "", (1, 0), LATENT_THREADS, 1, 0, f32, f32))
    out.append(Instance("latent_decode_merge", "", (2, 0), LATENT_MERGE_THREADS))
    return tuple(out)


def _empty_rows_instances() -> tuple[Instance, ...]:
    """flash_attention_empty_rows.cu: one thread a column, at most the
    widest head (256); no launch bounds."""
    return tuple(Instance("mean_v_kernel", _DT[dtype], (int(dtype == BF16),), 256)
                 for dtype in (F32, BF16))


def _rwkv6_seq_instances() -> tuple[Instance, ...]:
    """rwkv6_scan.cu: HD threads, rs, ks, ws [16][HD] and us[HD] floats."""
    from repro_torch.kernels.rwkv6_scan import HEAD_DIMS

    return tuple(Instance("rwkv6_kernel", str(hd), (hd,), hd, static_smem=4 * (3 * 16 + 1) * hd,
                          spills=("no config has an rwkv6 head size of 128 (rwkv6-1.6b's "
                                  "is 64)" if hd == 128 else None))
                 for hd in HEAD_DIMS)


def _correct_smem(hd: int, L: int) -> int:
    """rwkv6_scan_chunked.cu's correct_smem: the entry state and r_t P_t
    transposed, its steps rounded up to 8 (+ 4)."""
    return 4 * (hd * hd + hd * (((L + 7) & ~7) + 4))


def _rwkv6_chunked_instances() -> tuple[Instance, ...]:
    """rwkv6_scan_chunked.cu at the wrapper's CHUNK: the local pass (HD
    threads; two stages of r, k, w, v of 16 steps, u, the decays'
    products), the chunk scan (256), the correction (256; the opt-in at
    the entry's longest chunk, kMaxChunk = 128)."""
    from repro_torch.kernels.rwkv6_scan import CHUNK, HEAD_DIMS

    out = []
    for hd in HEAD_DIMS:
        local = 4 * (2 * 4 * 16 * hd + hd + 16)
        out += [Instance("local_pass", str(hd), (0, hd, CHUNK), hd, 1, 0, local, local),
                Instance("chunk_scan", str(hd), (1, hd, CHUNK), 256, 1, 0, 0, 0),
                Instance("correct", str(hd), (2, hd, CHUNK), 256, 1, 0,
                         _correct_smem(hd, CHUNK), _correct_smem(hd, 128))]
    return tuple(out)


def _grads_floats(hd: int, C: int) -> int:
    """rwkv6_scan_bwd.cu's grads_floats<HD>(C) (sub-chunks of L = 16)."""
    L = 16
    return (5 * C * (hd + 4) + hd * (hd + 4)
            + (hd * (hd + 4) + (C - L) * (hd + 4) if C > L else 0)
            + 2 * L * (hd + 4) + 3 * C * (hd + 4) + C * L
            + (C // L) * L * L * (1 + (hd // 32 if hd > 32 else 1))
            + 3 * (C // L) * hd + 4 * hd)


def _rwkv6_bwd_instances() -> tuple[Instance, ...]:
    """rwkv6_scan_bwd.cu at ``_bwd_chunk(hd)``: local (256 threads; r, k, v,
    w, dy of C steps at rows of HD + 4), chunk_scan (256, no opt-in), grads
    (256, one block an SM)."""
    from repro_torch.kernels.rwkv6_scan import HEAD_DIMS, _bwd_chunk

    out = []
    for hd in HEAD_DIMS:
        C = _bwd_chunk(hd)
        local, grads = 4 * 5 * C * (hd + 4), 4 * _grads_floats(hd, C)
        out += [Instance("local", str(hd), (0, hd, C), 256, 1, 0, local, local),
                Instance("chunk_scan", str(hd), (1, hd, C), 256),
                Instance("grads", str(hd), (2, hd, C), 256, 1, 0, grads, grads)]
    return tuple(out)


# --- calls, outputs and grids of each family ---------------------------------


def _distill_inputs(s):
    B, N, V, dt = s["B"], s["N"], s["V"], s["dtype"]
    return (T((B, N, V), dt), T((B, N, V), dt), T((B, N), I64), 1.5, 1.0), {}


def _xent_inputs(s):
    B, N, V, dt = s["B"], s["N"], s["V"], s["dtype"]
    return (T((B, N, V), dt), T((B, N), I64), 1.0), {}


def _rows_out(s):
    return (T((s["B"], s["N"]), F32),)


def _distill_grids(s):
    from repro_torch.kernels import distill_loss as DL

    rows, V, dt = s["B"] * s["N"], s["V"], s["dtype"]
    variant, threads = DL._fwd_variant(rows, V, dt)
    if variant == "regs":
        nt = max(threads, 128)
        fwd = ("fwd_regs", (_cdiv(rows, nt // threads), 1, 1), nt)
    else:
        fwd = ("fwd_stream", (rows, 1, 1), threads)
    _, tpr, slices = DL._bwd_variant(V, dt)
    return [fwd, ("bwd", (_cdiv(rows * slices, 256 // tpr), 1, 1), 256)]


def _skr_map_inputs(s):
    B, N, C = s["B"], s["N"], s["C"]
    return (T((B, N, C)), T((B, N), I64), T((B, C)), T((B, C), I32)), {}


def _skr_map_grids(s):
    return [("skr_rectify_kernel", (min(4096, _cdiv(s["B"] * s["N"] * s["C"], 256)), 1, 1),
             256)]


def _skr_process_inputs(s):
    B, N, C, Bq = s["B"], s["N"], s["C"], s["Bq"]
    return (T((B, N, C)), T((B, N), s["labels"]), T((B, C, Bq)), T((B, C), I32),
            T((B, C), I32)), {}


def _skr_process_out(s):
    B, N, C, Bq = s["B"], s["N"], s["C"], s["Bq"]
    return T((B, N, C)), T((B, C, Bq)), T((B, C), I32), T((B, C), I32)


def _attn_inputs(s):
    B, Sq, Sk, N, K, H = s["B"], s["Sq"], s["Sk"], s["N"], s["K"], s["H"]
    Hv, dt = s.get("Hv", H), s["dtype"]
    return ((T((B, Sq, N, H), dt), T((B, Sk, K, H), dt), T((B, Sk, K, Hv), dt)),
            {"causal": s.get("causal", True), "window": s.get("window", 0),
             "q_offset": s.get("q_offset", 0)})


def _attn_out(s):
    return (T((s["B"], s["Sq"], s["N"], s.get("Hv", s["H"])), s["dtype"]),)


def _attn_grids(s):
    from repro_torch.kernels import flash_attention as FA

    B, Sq, Sk, N, K, H = s["B"], s["Sq"], s["Sk"], s["N"], s["K"], s["H"]
    Hv, dt, G = s.get("Hv", H), s["dtype"], s["N"] // s["K"]
    causal, window, q_offset = s.get("causal", True), s.get("window", 0), s.get("q_offset", 0)
    variant = FA._variant(dt, Sq, H, Hv)
    if variant == "decode":
        _, _, splits = FA._decode_plan(B, K, Sk, q_offset, causal, window)
        gt = _decode_gt(G)
        out = [("flash_decode_split", (splits, K * _cdiv(G, gt), B), DECODE_THREADS)] \
            if splits else []  # no visible key: the merge pass alone writes the rows
        if splits != 1:
            out.append(("flash_decode_merge", (_cdiv(B * N, 4), 1, 1), DECODE_THREADS))
    elif variant == "sm90":
        threads = 384 if H == 256 else 256
        out = [("flash_sm90_kernel", (_cdiv(Sq * G, 128), K, B), threads)]
    else:
        c = _tf32x3_cfg(dt, H, Hv)
        out = [("flash_tf32x3_kernel", (_cdiv(Sq * G, c["bm"]), K, B), c["threads"])]
    if FA._has_empty_rows(Sq, Sk, q_offset, causal, window):
        out.append(("mean_v_kernel", (K, B, 1), Hv))
    return out


def _latent_inputs(s):
    B, S, N, dt = s["B"], s["S"], s["N"], s["dtype"]
    return ((T((B, 1, N, 576)), T((B, S, 512), dt), T((B, S, 64), dt)),
            {"scale": 192 ** -0.5, "q_offset": s["q_offset"]})


def _latent_out(s):
    return (T((s["B"], 1, s["N"], 512)),)


def _latent_grids(s):
    from repro_torch.kernels.flash_attention import _latent_plan

    _, splits, vsplits = _latent_plan(s["B"], s["S"], s["q_offset"])
    kernel = "latent_decode_wgmma" if s["dtype"] == BF16 else "latent_decode_mma"
    out = [(kernel, (splits * vsplits, s["B"], 1), LATENT_THREADS)]
    if splits > 1:
        out.append(("latent_decode_merge", (s["B"] * s["N"], 1, 1), LATENT_MERGE_THREADS))
    return out


def _rwkv_inputs(s):
    B, T_, H, hd = s["B"], s["T"], s["H"], s["hd"]
    x = T((B, T_, H, hd))
    return (x, x, x, x, T((H, hd)), T((B, H, hd, hd))), {}


def _rwkv_out(s):
    return T((s["B"], s["T"], s["H"], s["hd"])), T((s["B"], s["H"], s["hd"], s["hd"]))


def _rwkv_grids(s):
    from repro_torch.kernels import rwkv6_scan as RS

    B, T_, H, hd = s["B"], s["T"], s["H"], s["hd"]
    scan = ("chunk_scan", (_cdiv(B * H * hd * hd, 256), 1, 1), 256)
    if RS._variant(T_) == "seq":
        fwd = [("rwkv6_kernel", (B * H, 1, 1), hd)]
    else:
        nc = _cdiv(T_, RS.CHUNK)
        fwd = [("local_pass", (nc, H, B), hd), scan, ("correct", (nc, H, B), 256)]
    if not s.get("grad"):
        return fwd
    nc = _cdiv(T_, RS._bwd_chunk(hd))
    return fwd + [("local", (nc, H, B), 256), scan, ("grads", (nc, H, B), 256)]


_DISTILL_ENTRIES = ("distill_loss_fwd", "distill_loss_fwd_bf16", "distill_loss_bwd",
                    "distill_loss_bwd_bf16")
_ATTN_SHAPES_SM90 = (
    # llama3.2-3b's prefill, gemma3-12b's global layer, deepseek-v2-lite-16b's
    # expanded MLA prefill, zamba2-7b's shared block, whisper-small's decoder
    {"B": 1, "Sq": 4096, "Sk": 4096, "N": 24, "K": 8, "H": 128, "dtype": BF16},
    {"B": 1, "Sq": 4096, "Sk": 4096, "N": 16, "K": 8, "H": 256, "dtype": BF16},
    {"B": 1, "Sq": 4096, "Sk": 4096, "N": 16, "K": 16, "H": 192, "Hv": 128, "dtype": BF16},
    {"B": 1, "Sq": 4096, "Sk": 4096, "N": 32, "K": 32, "H": 112, "dtype": BF16},
    {"B": 1, "Sq": 4096, "Sk": 4096, "N": 12, "K": 12, "H": 64, "dtype": BF16},
)
_ATTN_SHAPES_TF32X3 = (
    # fp32 prefill at llama3.2-3b's width (PERF.md row 4b), the reduced
    # configs' (8, 256, 4/2, 32) in fp32 and bf16, and every other instance
    {"B": 1, "Sq": 4096, "Sk": 4096, "N": 24, "K": 8, "H": 128, "dtype": F32},
    {"B": 8, "Sq": 256, "Sk": 256, "N": 4, "K": 2, "H": 32, "dtype": F32},
    {"B": 8, "Sq": 256, "Sk": 256, "N": 4, "K": 2, "H": 32, "dtype": BF16},
    {"B": 1, "Sq": 1024, "Sk": 1024, "N": 12, "K": 12, "H": 64, "dtype": F32},
    {"B": 1, "Sq": 1024, "Sk": 1024, "N": 32, "K": 32, "H": 112, "dtype": F32},
    {"B": 1, "Sq": 1024, "Sk": 1024, "N": 16, "K": 16, "H": 192, "Hv": 128, "dtype": F32},
    {"B": 1, "Sq": 1024, "Sk": 1024, "N": 16, "K": 8, "H": 256, "dtype": F32},
)
_ATTN_SHAPES_DECODE = (
    # the serving batch of 8 against a 4096-long cache at its last position:
    # llama3.2-3b, gemma3-12b, zamba2-7b, whisper-small (and its cross
    # attention over 1500 frames, non-causal), and fp32 at the reduced width
    {"B": 8, "Sq": 1, "Sk": 4096, "N": 24, "K": 8, "H": 128, "dtype": BF16, "q_offset": 4095},
    {"B": 8, "Sq": 1, "Sk": 4096, "N": 16, "K": 8, "H": 256, "dtype": BF16, "q_offset": 4095},
    {"B": 8, "Sq": 1, "Sk": 4096, "N": 32, "K": 32, "H": 112, "dtype": BF16, "q_offset": 4095},
    {"B": 8, "Sq": 1, "Sk": 4096, "N": 12, "K": 12, "H": 64, "dtype": BF16, "q_offset": 4095},
    {"B": 8, "Sq": 1, "Sk": 1500, "N": 12, "K": 12, "H": 64, "dtype": BF16, "causal": False},
    {"B": 8, "Sq": 1, "Sk": 4096, "N": 24, "K": 8, "H": 128, "dtype": F32, "q_offset": 4095},
    {"B": 8, "Sq": 1, "Sk": 256, "N": 4, "K": 2, "H": 32, "dtype": F32, "q_offset": 255},
)
_ATTN_SHAPES_EMPTY = (
    # rows whose window ends before the keys do (ROADMAP C8): a decode step
    # through the decode kernel, a prefill through the 3xTF32 kernel
    {"B": 2, "Sq": 1, "Sk": 64, "N": 4, "K": 2, "H": 64, "dtype": BF16, "window": 8,
     "q_offset": 200},
    {"B": 2, "Sq": 16, "Sk": 64, "N": 4, "K": 2, "H": 64, "dtype": F32, "window": 4,
     "q_offset": 100},
)
_ATTN = dict(module="repro_torch.kernels.flash_attention", entry="flash_attention",
             inputs=_attn_inputs, expect=_attn_out, grids=_attn_grids)


def _contracts() -> dict[str, KernelContract]:
    table = [
        KernelContract(
            name="distill_loss", module="repro_torch.kernels.distill_loss",
            entry="distill_loss_batched", wrapper="distill_loss", function="DistillLoss",
            grad=True, source="distill_loss.cu", c_entries=_DISTILL_ENTRIES,
            attrs_entry="distill_loss_attrs", kernels=("fwd_regs", "fwd_stream", "bwd"),
            instances=_distill_instances(True),
            # the FedEEC bench shape, the LM distillation step's student loss
            # (fp32, the shared 128,256-token vocabulary), and bf16 at the LM
            # training loss's (1, 1024, 128256)
            shapes=({"B": 4, "N": 256, "V": 2048, "dtype": F32},
                    {"B": 1, "N": 128, "V": 128256, "dtype": F32},
                    {"B": 1, "N": 1024, "V": 128256, "dtype": BF16}),
            inputs=_distill_inputs, expect=_rows_out, grids=_distill_grids),
        KernelContract(
            name="softmax_xent", module="repro_torch.kernels.distill_loss",
            entry="softmax_xent_batched", wrapper="softmax_xent", function="SoftmaxXent",
            grad=True, source="distill_loss.cu",
            c_entries=tuple(e.replace("_bf16", "") + "_ce" + ("_bf16" if "bf16" in e else "")
                            for e in _DISTILL_ENTRIES),
            attrs_entry="distill_loss_attrs", kernels=("fwd_regs", "fwd_stream", "bwd"),
            instances=_distill_instances(False),
            # the bench shape, and the LM training losses in bf16: llama3.2-3b's
            # vocabulary and zamba2-7b's
            shapes=({"B": 4, "N": 256, "V": 2048, "dtype": F32},
                    {"B": 1, "N": 1024, "V": 128256, "dtype": BF16},
                    {"B": 1, "N": 1024, "V": 32000, "dtype": BF16}),
            inputs=_xent_inputs, expect=_rows_out, grids=_distill_grids),
        KernelContract(
            name="skr_rectify", module="repro_torch.kernels.skr_rectify",
            entry="skr_rectify_batched", wrapper="skr_rectify", source="skr_rectify.cu",
            c_entries=("skr_rectify",), attrs_entry="skr_rectify_attrs",
            kernels=("skr_rectify_kernel",),
            instances=(Instance("skr_rectify_kernel", "", (0,), 256),),
            shapes=({"B": 4, "N": 256, "C": 1024}, {"B": 1, "N": 8, "C": 10}),
            inputs=_skr_map_inputs, expect=lambda s: (T((s["B"], s["N"], s["C"])),),
            grids=_skr_map_grids),
        KernelContract(
            name="skr_process", module="repro_torch.kernels.skr_rectify",
            entry="skr_process_batched", wrapper="skr_process_rows", source="skr_rectify.cu",
            c_entries=("skr_process",), attrs_entry="skr_rectify_attrs",
            kernels=("skr_process_kernel",),
            instances=(Instance("skr_process_kernel", "int", (1,), 512,
                                static_smem=1024 * (4 + 4 + 4 + 1)),
                       Instance("skr_process_kernel", "long long", (2,), 512,
                                static_smem=1024 * (4 + 4 + 4 + 1))),
            # the bench shape (4 pairs, queues of 20), the LM distillation
            # step's teacher step (int32 labels: the other instance)
            shapes=({"B": 4, "N": 256, "C": 1024, "Bq": 20, "labels": I64},
                    {"B": 1, "N": 128, "C": 128256, "Bq": 20, "labels": I32}),
            inputs=_skr_process_inputs, expect=_skr_process_out,
            grids=lambda s: [("skr_process_kernel", (s["B"], 1, 1), 512)]),
        KernelContract(
            name="flash_attention_sm90", source="flash_attention_sm90.cu",
            c_entries=("flash_attention_sm90",), attrs_entry="flash_attention_sm90_attrs",
            kernels=("flash_sm90_kernel", "flash_sm90_h256_kernel"),
            instances=_sm90_instances(), shapes=_ATTN_SHAPES_SM90, tensor_core=True, **_ATTN),
        KernelContract(
            name="flash_attention_tf32x3", source="flash_attention.cu",
            c_entries=("flash_attention",), attrs_entry="flash_attention_attrs",
            kernels=("flash_tf32x3_kernel",), instances=_tf32x3_instances(),
            shapes=_ATTN_SHAPES_TF32X3, tensor_core=True, **_ATTN),
        KernelContract(
            name="flash_attention_decode", source="flash_attention_decode.cu",
            c_entries=("flash_attention_decode",), attrs_entry="flash_attention_decode_attrs",
            kernels=("flash_decode_split", "flash_decode_merge"),
            instances=_decode_instances(), shapes=_ATTN_SHAPES_DECODE, **_ATTN),
        KernelContract(
            name="flash_attention_latent_decode", module="repro_torch.kernels.flash_attention",
            entry="latent_decode", source="flash_attention_latent_decode.cu",
            c_entries=("flash_attention_latent_decode",),
            attrs_entry="flash_attention_latent_decode_attrs",
            kernels=("latent_decode_wgmma", "latent_decode_mma", "latent_decode_merge"),
            instances=_latent_instances(), tensor_core=True,
            # deepseek-v2-lite-16b's serving batch against its 4096-row cache:
            # a full cache (16 splits), q_offset 127 (value-column groups), a
            # short range, and an fp32 cache
            shapes=({"B": 8, "S": 4096, "N": 16, "dtype": BF16, "q_offset": 4095},
                    {"B": 8, "S": 4096, "N": 16, "dtype": BF16, "q_offset": 127},
                    {"B": 8, "S": 4096, "N": 16, "dtype": BF16, "q_offset": 0},
                    {"B": 8, "S": 4096, "N": 16, "dtype": F32, "q_offset": 4095}),
            inputs=_latent_inputs, expect=_latent_out, grids=_latent_grids),
        KernelContract(
            name="flash_attention_empty_rows", source="flash_attention_empty_rows.cu",
            c_entries=("flash_attention_empty_rows", "flash_attention_decode",
                       "flash_attention"),
            attrs_entry="flash_attention_empty_rows_attrs", kernels=("mean_v_kernel",),
            instances=_empty_rows_instances(), shapes=_ATTN_SHAPES_EMPTY, **_ATTN),
        KernelContract(
            name="rwkv6_scan", module="repro_torch.kernels.rwkv6_scan", entry="rwkv6_scan",
            function="Rwkv6Scan", source="rwkv6_scan.cu", c_entries=("rwkv6_scan",),
            attrs_entry="rwkv6_scan_attrs", kernels=("rwkv6_kernel",),
            instances=_rwkv6_seq_instances(),
            # rwkv6-1.6b's decode step of the serving batch, and the longest
            # T the sequential kernel takes
            shapes=({"B": 8, "T": 1, "H": 32, "hd": 64}, {"B": 1, "T": 16, "H": 32, "hd": 64}),
            inputs=_rwkv_inputs, expect=_rwkv_out, grids=_rwkv_grids),
        KernelContract(
            name="rwkv6_scan_chunked", module="repro_torch.kernels.rwkv6_scan",
            entry="rwkv6_scan", function="Rwkv6Scan", source="rwkv6_scan_chunked.cu",
            c_entries=("rwkv6_scan_chunked",), attrs_entry="rwkv6_scan_chunked_attrs",
            kernels=("local_pass", "chunk_scan", "correct"),
            instances=_rwkv6_chunked_instances(),
            # rwkv6-1.6b's prefill of 1024 tokens, and a ragged last chunk
            shapes=({"B": 1, "T": 1024, "H": 32, "hd": 64}, {"B": 2, "T": 1000, "H": 32,
                                                            "hd": 64}),
            inputs=_rwkv_inputs, expect=_rwkv_out, grids=_rwkv_grids),
        KernelContract(
            name="rwkv6_scan_bwd", module="repro_torch.kernels.rwkv6_scan",
            entry="rwkv6_scan", function="Rwkv6Scan", grad=True, source="rwkv6_scan_bwd.cu",
            c_entries=("rwkv6_scan_chunked", "rwkv6_scan_bwd"),
            attrs_entry="rwkv6_scan_bwd_attrs", kernels=("local", "chunk_scan", "grads"),
            instances=_rwkv6_bwd_instances(), tensor_core=True,
            # rwkv6-1.6b's training step (2 x 1024 tokens)
            shapes=({"B": 2, "T": 1024, "H": 32, "hd": 64, "grad": True},),
            inputs=_rwkv_inputs, expect=_rwkv_out, grids=_rwkv_grids),
    ]
    return {c.name: c for c in table}


CONTRACTS: dict[str, KernelContract] = _contracts()


# ---------------------------------------------------------------------------
# Reading the sources
# ---------------------------------------------------------------------------


def _source(contract: KernelContract) -> str:
    return (CSRC / contract.source).read_text()


def _line_of(text: str, pattern: str, default: int = 1) -> int:
    m = re.search(pattern, text, re.M)
    return text.count("\n", 0, m.start()) + 1 if m else default


def _entry_line(contract: KernelContract) -> int:
    try:
        mod = importlib.import_module(contract.module)
        return inspect.getsourcelines(getattr(mod, contract.entry))[1]
    except Exception:
        return 1


_EXTERN_RE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _c_kind(param: str) -> str:
    """pointer, int, long long, float or stream: the kind of a C parameter
    declaration (its name dropped)."""
    decl = " ".join(param.replace("*", " * ").split())
    if "*" in decl:
        return "pointer"
    words = decl.split()[:-1]  # the type, without the name
    words = [w for w in words if w not in ("const", "unsigned", "signed")]
    typ = " ".join(words)
    return {"cudaStream_t": "stream", "int": "int", "long long": "long long",
            "long long int": "long long", "float": "float"}.get(typ, typ)


def c_entries(sources: dict[str, str] | None = None) -> dict[str, tuple[str, int, list[str]]]:
    """Every ``extern "C"`` declaration in ``csrc/*.cu``: name -> (file,
    line, argument kinds)."""
    if sources is None:
        sources = {p.name: p.read_text() for p in sorted(CSRC.glob("*.cu"))}
    out = {}
    for fname, text in sorted(sources.items()):
        for m in _EXTERN_RE.finditer(text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = (fname, text.count("\n", 0, m.start()) + 1,
                               [_c_kind(p) for p in params])
    return out


def _ctypes_kind(t) -> str:
    if t is ctypes.c_void_p or (isinstance(t, type) and issubclass(t, ctypes._Pointer)):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_longlong: "long long",
            ctypes.c_float: "float"}.get(t, getattr(t, "__name__", str(t)))


def check_signatures(signatures: dict | None = None,
                     sources: dict[str, str] | None = None) -> list[Finding]:
    """KRN001's C side: each C entry's argument kinds against its ctypes
    argument types in ``_lib._SIGNATURES`` (a stream is passed as a
    pointer, and only as the last argument), and a counterpart for every
    name on either side."""
    from repro_torch.kernels import _lib

    signatures = _lib._SIGNATURES if signatures is None else signatures
    lib_path = "src/repro_torch/kernels/_lib.py"
    lib_text = Path(inspect.getsourcefile(_lib)).read_text()
    entries = c_entries(sources)
    out: list[Finding] = []
    for name, (fname, line, kinds) in entries.items():
        path = f"{CSRC_REL}/{fname}"
        if name not in signatures:
            out.append(Finding("KRN001", path, line,
                               f"C entry {name} has no _lib._SIGNATURES entry",
                               engine="kernel"))
            continue
        got = [_ctypes_kind(t) for t in signatures[name]]
        want = ["pointer" if k == "stream" else k for k in kinds]
        if "stream" in kinds[:-1]:
            out.append(Finding("KRN001", path, line,
                               f"C entry {name} takes its stream before its last argument "
                               "(_lib.launch appends it last)", engine="kernel"))
        if got != want:
            out.append(Finding(
                "KRN001", path, line,
                f"C entry {name} takes ({', '.join(kinds)}) but _lib._SIGNATURES binds "
                f"({', '.join(got)})", engine="kernel"))
    for name in sorted(set(signatures) - set(entries)):
        out.append(Finding("KRN001", lib_path, _line_of(lib_text, rf'"{name}"'),
                           f"_lib._SIGNATURES binds {name}, which no csrc/*.cu declares "
                           'extern "C"', engine="kernel"))
    return out


# ---------------------------------------------------------------------------
# Tracing on the meta device (the counterpart of jax.eval_shape)
# ---------------------------------------------------------------------------


def _make(arg, device, requires_grad=False):
    if not isinstance(arg, T):
        return arg
    if device.type == "meta":
        t = torch.empty(arg.shape, dtype=arg.dtype, device=device)
    else:  # on the card: zeros are in range for every kernel (labels, queue state)
        t = torch.zeros(arg.shape, dtype=arg.dtype, device=device)
    return t.requires_grad_(True) if requires_grad else t


def _outputs(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _specs(tensors) -> tuple[T, ...]:
    return tuple(T(tuple(t.shape), t.dtype) for t in tensors)


def trace(contract: KernelContract, shape: dict, device="meta", fn: str | None = None,
          slice_b: bool = False) -> dict:
    """Call ``fn`` (default the contract's entry) at ``shape`` on ``device``:
    its outputs' specs, its gradient's spec (a differentiable contract's
    backward, from inputs[0]), the grad_fn's name, and on ``meta`` the C
    entries it reached. ``slice_b`` drops the batch axis of every input (a
    2-D wrapper's call)."""
    from repro_torch.kernels import _lib

    device = torch.device(device)
    mod = importlib.import_module(contract.module)
    call = getattr(mod, fn or contract.entry)
    args, kwargs = contract.inputs(shape)
    if slice_b:
        args = tuple(T(a.shape[1:], a.dtype) if isinstance(a, T) else a for a in args)
    grad = contract.grad and not slice_b
    tensors = [_make(a, device, requires_grad=grad and i == 0) for i, a in enumerate(args)]
    heard: list[str] = []
    with _lib.meta_sink(lambda name, flops, nbytes: heard.append(name)), \
            torch.set_grad_enabled(grad):
        out = _outputs(call(*tensors, **kwargs))
        result = {"out": _specs(out), "entries": heard,
                  "grad_fn": type(out[0].grad_fn).__name__ if out[0].grad_fn else None}
        if grad:
            loss = sum(o.float().sum() for o in out)
            (g,) = torch.autograd.grad(loss, [tensors[0]])
            result["grad"] = _specs([g])[0]
    return result


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _finding(rule: str, contract: KernelContract, msg: str, line: int | None = None,
             path: str | None = None) -> Finding:
    return Finding(rule, path or contract.source_path(),
                   _entry_line(contract) if line is None else line,
                   f"{contract.name}: {msg}", engine="kernel")


def _kernel_line(contract: KernelContract, kernel: str, text: str | None = None) -> int:
    text = _source(contract) if text is None else text
    return _line_of(text, rf"^\s*{re.escape(kernel)}\s*\(|__global__[^;{{]*\b{re.escape(kernel)}\b")


def check_trace(contract: KernelContract, shape: dict) -> list[Finding]:
    """KRN001's Python side: the entry traced on meta at ``shape`` gives
    the contracted outputs and reaches only the family's C entries."""
    try:
        got = trace(contract, shape)
    except Exception as e:  # tracing is the check
        return [_finding("KRN001", contract, f"{contract.entry} failed to trace on meta at "
                         f"{_label(shape)}: {type(e).__name__}: {e}")]
    out = []
    want = tuple(contract.expect(shape))
    if got["out"] != want:
        out.append(_finding("KRN001", contract,
                            f"{contract.entry} gives {_show(got['out'])} at {_label(shape)}, "
                            f"the contract {_show(want)}"))
    stray = sorted(set(got["entries"]) - set(contract.c_entries))
    if not got["entries"] or stray:
        out.append(_finding("KRN001", contract,
                            f"{contract.entry} at {_label(shape)} reached C entries "
                            f"{got['entries'] or 'none'}, not only {list(contract.c_entries)}"))
    return out


def _label(shape: dict) -> str:
    return "(" + ", ".join(f"{k} {_dt(v)}" for k, v in shape.items()) + ")"


def _dt(v) -> str:
    return str(v).replace("torch.", "") if isinstance(v, torch.dtype) else str(v)


def _show(specs) -> str:
    return ", ".join(f"{tuple(s.shape)} {_dt(s.dtype)}" for s in specs)


def _config_pairs() -> dict[str, list]:
    """What each registered config asks of the attention and scan kernels:
    its (H, Hv) pairs for prefill and decode, MLA's latent (L, R, heads)
    for its absorbed decode, and its rwkv6 head sizes."""
    from repro_torch.configs import get_arch, list_archs, load_all

    load_all()
    need: dict[str, list] = {}
    for arch in list_archs():
        cfg = get_arch(arch)
        kinds = {b.kind for b in cfg.blocks}
        want = need.setdefault(arch, [])
        if kinds & {"attn", "local_attn", "moe", "shared_attn"}:
            want += [("prefill", (cfg.head_dim, cfg.head_dim)),
                     ("decode", (cfg.head_dim, cfg.head_dim))]
        if kinds & {"mla", "mla_moe"}:
            want += [("prefill", (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)),
                     ("latent", (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.num_heads))]
        if "rwkv6" in kinds:
            want.append(("rwkv6", cfg.ssm_head_dim))
    return need


def check_coverage(sm90=None, tf32x3=None, decode=None, rwkv=None, latent=None,
                   needs: dict[str, list] | None = None) -> list[Finding]:
    """KRN002's configs: every head dim or (H, Hv) pair a registered config
    uses has an instance in ``SM90_INSTANCES`` (bf16 prefill),
    ``TF32X3_INSTANCES`` (fp32 prefill) and the decode kernel's
    ``HEAD_DIMS``; MLA's latent decode takes the config's (L, R) and heads;
    every rwkv6 head size is in ``rwkv6_scan.HEAD_DIMS``."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RS

    sm90 = FA.SM90_INSTANCES if sm90 is None else sm90
    tf32x3 = FA.TF32X3_INSTANCES if tf32x3 is None else tf32x3
    decode = FA.HEAD_DIMS if decode is None else decode
    rwkv = RS.HEAD_DIMS if rwkv is None else rwkv
    latent = (*FA.LATENT_DIMS, FA.LATENT_MAX_HEADS) if latent is None else latent
    needs = _config_pairs() if needs is None else needs
    fa_path, rs_path = "src/repro_torch/kernels/flash_attention.py", \
        "src/repro_torch/kernels/rwkv6_scan.py"
    fa_text = Path(inspect.getsourcefile(FA)).read_text()
    rs_text = Path(inspect.getsourcefile(RS)).read_text()
    out = []

    def miss(path, text, name, msg):
        out.append(Finding("KRN002", path, _line_of(text, rf"^{name}\b"), msg, engine="kernel"))

    for arch, wants in sorted(needs.items()):
        for kind, what in wants:
            if kind == "prefill":
                if what not in sm90:
                    miss(fa_path, fa_text, "SM90_INSTANCES",
                         f"{arch}'s bf16 prefill at (H, Hv) {what} has no sm90 instance")
                if what not in tf32x3:
                    miss(fa_path, fa_text, "TF32X3_INSTANCES",
                         f"{arch}'s fp32 prefill at (H, Hv) {what} has no tf32x3 instance")
            elif kind == "decode":
                if what[0] != what[1] or what[0] not in decode:
                    miss(fa_path, fa_text, "HEAD_DIMS",
                         f"{arch}'s decode at (H, Hv) {what} has no decode kernel instance")
            elif kind == "latent":
                if what[:2] != tuple(latent[:2]) or what[2] > latent[2]:
                    miss(fa_path, fa_text, "LATENT_DIMS",
                         f"{arch}'s absorbed decode at (L, R, heads) {what} does not fit the "
                         f"latent kernel's {tuple(latent)}")
            elif what not in rwkv:
                miss(rs_path, rs_text, "HEAD_DIMS",
                     f"{arch}'s rwkv6 head size {what} is not in rwkv6_scan.HEAD_DIMS {rwkv}")
    return out


# the plans' constants and the kernels': (source, C constant, module, name)
PLAN_CONSTANTS = (
    ("flash_attention_latent_decode.cu", "kMaxSplits", "flash_attention", "LATENT_MAX_SPLITS"),
    ("flash_attention_latent_decode.cu", "kMaxVsplits", "flash_attention",
     "LATENT_MAX_VSPLITS"),
    ("flash_attention_latent_decode.cu", "kHeads", "flash_attention", "LATENT_MAX_HEADS"),
    ("flash_attention_latent_decode.cu", "kIt", "flash_attention", "LATENT_TILE"),
    ("rwkv6_scan_bwd.cu", "kSubChunk", "rwkv6_scan", "BWD_SUB"),
)


def check_plans(decode_plan=None, latent_plan=None, sources: dict[str, str] | None = None
                ) -> list[Finding]:
    """KRN002's plans: ``_decode_plan``'s chunks are multiples of
    ``DECODE_CHUNK_ALIGN`` and its splits cover the visible keys with none
    empty; ``_latent_plan`` keeps to ``LATENT_MAX_SPLITS`` /
    ``LATENT_MAX_VSPLITS``, chunks of ``LATENT_TILE`` multiples (and of the
    kernel's kChunkAlign), its splits cover the keys and its grid stays
    within one wave; and the plans' constants are the kernels'."""
    from repro_torch.kernels import flash_attention as FA

    decode_plan = FA._decode_plan if decode_plan is None else decode_plan
    latent_plan = FA._latent_plan if latent_plan is None else latent_plan
    path = "src/repro_torch/kernels/flash_attention.py"
    text = Path(inspect.getsourcefile(FA)).read_text()
    out = []
    seen = set()

    def bad(fn, msg):
        if (fn, msg) not in seen:
            seen.add((fn, msg))
            out.append(Finding("KRN002", path, _line_of(text, rf"^def {fn}\b"), msg,
                               engine="kernel"))

    for B, K in ((1, 1), (8, 8), (8, 32), (64, 8), (1, 32)):
        for k_len in (1, 63, 64, 1500, 4096, 32768):
            for q_offset in (0, 63, k_len - 1, k_len + 7):
                for causal, window in ((True, 0), (False, 0), (True, 1024), (True, 1)):
                    j_lo, chunk, splits = decode_plan(B, K, k_len, q_offset, causal, window)
                    j_hi = min(k_len - 1, q_offset) if causal else k_len - 1
                    n = j_hi - j_lo + 1
                    where = f"(B {B}, K {K}, k_len {k_len}, q_offset {q_offset}, " \
                            f"causal {causal}, window {window})"
                    if n <= 0:
                        if splits:
                            bad("_decode_plan", f"_decode_plan gives {splits} splits for an "
                                f"empty key range at {where}")
                        continue
                    if chunk % FA.DECODE_CHUNK_ALIGN:
                        bad("_decode_plan", f"_decode_plan's chunk {chunk} is no multiple of "
                            f"DECODE_CHUNK_ALIGN {FA.DECODE_CHUNK_ALIGN} at {where}")
                    if splits * chunk < n or (splits - 1) * chunk >= n:
                        bad("_decode_plan", f"_decode_plan's {splits} splits of {chunk} do "
                            f"not cover {n} keys with none empty at {where}")
    for B in (1, 8, 16, 132, 200):
        for S in (1, 64, 4096, 32768):
            for q_offset in (0, 1, 63, 64, 127, S - 1, S + 9):
                chunk, splits, vsplits = latent_plan(B, S, q_offset)
                n = min(q_offset, S - 1) + 1
                where = f"(B {B}, S {S}, q_offset {q_offset})"
                if not 1 <= splits <= FA.LATENT_MAX_SPLITS:
                    bad("_latent_plan", f"_latent_plan's {splits} splits pass "
                        f"LATENT_MAX_SPLITS {FA.LATENT_MAX_SPLITS} at {where}")
                if vsplits not in (1, 2, 4) or vsplits > FA.LATENT_MAX_VSPLITS:
                    bad("_latent_plan", f"_latent_plan's {vsplits} value-column groups pass "
                        f"LATENT_MAX_VSPLITS {FA.LATENT_MAX_VSPLITS} at {where}")
                if chunk % FA.LATENT_TILE or chunk % 32:
                    bad("_latent_plan", f"_latent_plan's chunk {chunk} is no multiple of "
                        f"LATENT_TILE {FA.LATENT_TILE} at {where}")
                if splits * chunk < n or (splits - 1) * chunk >= n:
                    bad("_latent_plan", f"_latent_plan's {splits} splits of {chunk} do not "
                        f"cover {n} keys with none empty at {where}")
                if B <= FA.SMS and B * splits * vsplits > FA.SMS:
                    bad("_latent_plan", f"_latent_plan's grid of {B * splits * vsplits} "
                        f"blocks passes one wave of {FA.SMS} at {where}")
    if sources is None:
        sources = {p.name: p.read_text() for p in sorted(CSRC.glob("*.cu"))}
    for fname, cname, modname, pyname in PLAN_CONSTANTS:
        m = re.search(rf"constexpr int {cname} = (\d+);", sources.get(fname, ""))
        mod = importlib.import_module(f"repro_torch.kernels.{modname}")
        if m is None or int(m.group(1)) != getattr(mod, pyname):
            out.append(Finding(
                "KRN002", f"{CSRC_REL}/{fname}", _line_of(sources.get(fname, ""), rf"\b{cname}\b"),
                f"{modname}.{pyname} = {getattr(mod, pyname)} but {fname}'s {cname} is "
                f"{m.group(1) if m else 'missing'}", engine="kernel"))
    return out


def check_grids(contract: KernelContract, shape: dict) -> list[Finding]:
    """KRN002's grids: every launch of the contract shape has a grid within
    CUDA's limits (no zero dimension) and at most 1,024 threads a block."""
    out = []
    for kernel, grid, threads in contract.grids(shape):
        grid = tuple(grid) + (1,) * (3 - len(grid))
        if any(g < 1 or g > lim for g, lim in zip(grid, GRID_LIMITS)) or \
                not 1 <= threads <= THREADS_PER_BLOCK:
            out.append(_finding("KRN002", contract,
                                f"{kernel}'s launch at {_label(shape)} has grid {grid} and "
                                f"{threads} threads, outside CUDA's limits {GRID_LIMITS} and "
                                f"{THREADS_PER_BLOCK}", path=f"{CSRC_REL}/{contract.source}",
                                line=_kernel_line(contract, kernel)))
    return out


_OPT_IN_RE = re.compile(r"\b(?:cudaFuncSetAttribute|configure)\s*\(\s*([A-Za-z_]\w*)")


def opted_in(source: str) -> set[str]:
    """The kernels a source opts in to more dynamic shared memory for: the
    first argument of its cudaFuncSetAttribute calls (or of a ``configure``
    helper that makes them) where it sets the maximum."""
    if "cudaFuncAttributeMaxDynamicSharedMemorySize" not in source:
        return set()
    return set(_OPT_IN_RE.findall(source)) - {"kernel"}


def check_resources(contract: KernelContract, limit: int = DEFAULT_SMEM_LIMIT,
                    source: str | None = None) -> list[Finding]:
    """KRN003: each instance's shared memory and threads against sm_90's."""
    source = _source(contract) if source is None else source
    path = f"{CSRC_REL}/{contract.source}"
    opts = opted_in(source)
    out = []
    for inst in contract.instances:
        line = _kernel_line(contract, inst.kernel, source)

        def bad(msg):
            out.append(_finding("KRN003", contract, f"{inst.name}: {msg}", line=line, path=path))

        total = inst.static_smem + inst.dynamic_smem
        if inst.static_smem > SMEM_STATIC:
            bad(f"{inst.static_smem} B of static shared memory, over {SMEM_STATIC}")
        if total > limit:
            bad(f"{inst.static_smem} + {inst.dynamic_smem} B of shared memory, over the "
                f"limit {limit}")
        if total > SMEM_STATIC:
            if inst.kernel not in opts:
                bad(f"{inst.dynamic_smem} B of dynamic shared memory past {SMEM_STATIC} and "
                    "no cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for it in "
                    f"{contract.source}")
            elif inst.opt_in is None or inst.opt_in < inst.dynamic_smem:
                bad(f"its launch passes {inst.dynamic_smem} B of dynamic shared memory, "
                    f"its opt-in is {inst.opt_in}")
        if inst.opt_in is not None and inst.opt_in + inst.static_smem > limit:
            bad(f"an opt-in of {inst.opt_in} B, over the limit {limit}")
        if inst.threads > THREADS_PER_BLOCK or \
                inst.threads * inst.min_blocks > THREADS_PER_SM:
            bad(f"{inst.threads} threads x {inst.min_blocks} blocks, over {THREADS_PER_SM} a "
                "multiprocessor")
    return out


_MMA_RE = re.compile(r'"\s*((?:wgmma\.mma_async|mma\.sync)[\w.]*)')


def mma_instructions(source: str) -> list[tuple[int, str, str]]:
    """(line, instruction, its D type) of every mma.sync / wgmma.mma_async
    instruction string in a source: D's type is the first type after the
    shape and the layouts."""
    out = []
    for m in _MMA_RE.finditer(source):
        parts = m.group(1).split(".")
        shape = next((i for i, p in enumerate(parts) if re.fullmatch(r"m\d+n\d+k\d+", p)), None)
        rest = [p for p in parts[shape + 1:] if p not in ("row", "col")] if shape is not None \
            else []
        out.append((source.count("\n", 0, m.start()) + 1, m.group(1), rest[0] if rest else ""))
    return out


def check_fp32_accum(contract: KernelContract, source: str | None = None) -> list[Finding]:
    """KRN004: every tensor-core instruction of the family's source
    accumulates in f32, and a tensor-core family has one."""
    source = _source(contract) if source is None else source
    path = f"{CSRC_REL}/{contract.source}"
    found = mma_instructions(source)
    out = [_finding("KRN004", contract, f"`{instr}` accumulates in {d or 'no type'}, not f32",
                    line=line, path=path)
           for line, instr, d in found if d != "f32"]
    if contract.tensor_core and not found:
        out.append(_finding("KRN004", contract, f"a tensor-core kernel with no mma.sync or "
                            f"wgmma.mma_async instruction in {contract.source}", line=1,
                            path=path))
    return out


def check_vjp_pairing(contract: KernelContract, shape: dict) -> list[Finding]:
    """KRN005: the autograd.Function and its backward, the 2-D wrapper's B =
    1 slice, or a forward-only wrapper's refusal of grad."""
    from repro_torch.kernels import _lib

    out = []
    mod = importlib.import_module(contract.module)
    if contract.function is not None:
        fn = getattr(mod, contract.function, None)
        if not (isinstance(fn, type) and issubclass(fn, torch.autograd.Function)):
            out.append(_finding("KRN005", contract, f"{contract.module}.{contract.function} is "
                                "no torch.autograd.Function"))
        elif contract.grad:
            try:
                got = trace(contract, shape)
                first = contract.inputs(shape)[0][0]
                if got["grad_fn"] != contract.function + "Backward":
                    out.append(_finding("KRN005", contract,
                                        f"{contract.entry}'s output has grad_fn "
                                        f"{got['grad_fn']}, not {contract.function}'s"))
                if got["grad"] != T(first.shape, first.dtype):
                    out.append(_finding("KRN005", contract,
                                        f"the backward gives {_show([got['grad']])} for an "
                                        f"input of {_show([first])}"))
            except Exception as e:
                out.append(_finding("KRN005", contract, f"the backward failed to trace on meta "
                                    f"at {_label(shape)}: {type(e).__name__}: {e}"))
    else:
        args, kwargs = contract.inputs(shape)
        meta = torch.device("meta")
        tensors = [_make(a, meta, requires_grad=i == 0) for i, a in enumerate(args)]
        refused = False
        try:
            with torch.enable_grad(), _lib.meta_sink(lambda *a: None):
                getattr(mod, contract.entry)(*tensors, **kwargs)
        except RuntimeError as e:
            refused = "no backward" in str(e)
        if not refused:
            out.append(_finding("KRN005", contract,
                                f"{contract.entry} is forward-only but lets an input that "
                                "requires grad through (no _lib.refuse_grad)"))
    if contract.wrapper is not None:
        if getattr(mod, contract.wrapper, None) is None:
            out.append(_finding("KRN005", contract, f"batched entry {contract.entry} has no "
                                f"2-D wrapper {contract.wrapper}"))
        else:
            try:
                got = trace(contract, shape, fn=contract.wrapper, slice_b=True)
                want = tuple(T(s.shape[1:], s.dtype) for s in contract.expect(shape))
                if got["out"] != want:
                    out.append(_finding("KRN005", contract,
                                        f"wrapper {contract.wrapper} gives {_show(got['out'])}, "
                                        f"not the B = 1 slice {_show(want)}"))
            except Exception as e:
                out.append(_finding("KRN005", contract, f"wrapper {contract.wrapper} failed to "
                                    f"trace on meta: {type(e).__name__}: {e}"))
    return out


def check_kernel(contract: KernelContract, limit: int = DEFAULT_SMEM_LIMIT) -> list[Finding]:
    out = []
    for shape in contract.shapes:
        out += check_trace(contract, shape)
        out += check_grids(contract, shape)
    out += check_resources(contract, limit)
    out += check_fp32_accum(contract)
    out += check_vjp_pairing(contract, contract.shapes[0])
    return out


def check_all(limit: int = DEFAULT_SMEM_LIMIT,
              contracts: dict[str, KernelContract] | None = None) -> list[Finding]:
    """Every contract's checks, then the C entries against
    ``_lib._SIGNATURES`` and the configs' and plans' coverage."""
    contracts = CONTRACTS if contracts is None else contracts
    findings: list[Finding] = []
    for name in sorted(contracts):
        findings += check_kernel(contracts[name], limit)
    findings += check_signatures()
    findings += check_coverage()
    findings += check_plans()
    return findings


def contract_table(limit: int = DEFAULT_SMEM_LIMIT) -> dict:
    """The per-kernel view: each family's shapes, instances and what its
    checks found (deterministic: no clock, no card)."""
    table: dict[str, dict] = {}
    for name in sorted(CONTRACTS):
        c = CONTRACTS[name]
        table[name] = {
            "source": f"{CSRC_REL}/{c.source}",
            "entry": f"{c.module}.{c.entry}",
            "c_entries": list(c.c_entries),
            "shapes": [{k: _dt(v) for k, v in sorted(s.items())} for s in c.shapes],
            "instances": [{"name": i.name, "threads": i.threads, "min_blocks": i.min_blocks,
                           "static_smem": i.static_smem, "dynamic_smem": i.dynamic_smem,
                           "opt_in": i.opt_in, "reg_cap": i.reg_cap(), "spills": i.spills}
                          for i in c.instances],
            "fp32_accum": c.tensor_core,
            "vjp": ("autograd.Function" if c.grad else "wrapper-only" if c.wrapper
                    else "forward-only"),
            "ok": not check_kernel(c, limit),
        }
    return table


# ---------------------------------------------------------------------------
# The mirror against the card (chip_smoke.py's static analysis phase and
# tests/test_torch_gpu.py; each needs a card and the built kernels)
# ---------------------------------------------------------------------------


def card_attrs(contract: KernelContract, inst: Instance,
               limit: int = DEFAULT_SMEM_LIMIT) -> tuple[dict, list[str]]:
    """The instance's attributes on the card (``_lib.kernel_attrs``, after
    the opt-in its launch makes) and what disagrees with its mirror: static
    shared bytes, the dynamic bytes its launch passes, the opt-in's bytes,
    registers within ``reg_cap``, threads within the card's most a block,
    and local bytes (0 unless the table says why it spills)."""
    from repro_torch.kernels import _lib

    a = _lib.kernel_attrs(contract.attrs_entry, *inst.attrs)
    bad = []
    if a["static_smem"] != inst.static_smem:
        bad.append(f"static shared {a['static_smem']} B, the mirror {inst.static_smem}")
    if a["dynamic_smem"] != inst.dynamic_smem:
        bad.append(f"dynamic shared {a['dynamic_smem']} B at launch, the mirror "
                   f"{inst.dynamic_smem}")
    if inst.opt_in is not None and a["max_dynamic_smem"] != inst.opt_in:
        bad.append(f"opt-in {a['max_dynamic_smem']} B, the mirror {inst.opt_in}")
    if a["static_smem"] + a["dynamic_smem"] > limit:
        bad.append(f"{a['static_smem'] + a['dynamic_smem']} B of shared memory, over {limit}")
    if a["regs"] > inst.reg_cap():
        bad.append(f"{a['regs']} registers, over the cap {inst.reg_cap()}")
    if a["max_threads"] < inst.threads:
        bad.append(f"at most {a['max_threads']} threads a block, the launch takes "
                   f"{inst.threads}")
    if bool(a["local_bytes"]) != (inst.spills is not None):
        bad.append(f"{a['local_bytes']} local bytes, the mirror "
                   + (f"expects some ({inst.spills})" if inst.spills else "none"))
    return a, bad


def card_trace(contract: KernelContract, shape: dict, device) -> tuple[dict, list[str]]:
    """The contract shape through the entry on the card (inputs of zeros,
    under grad for a differentiable contract) against its meta trace: the
    meta trace, and what differs."""
    meta = trace(contract, shape)
    card = trace(contract, shape, device)
    torch.cuda.synchronize(device)
    bad = []
    if card["out"] != meta["out"]:
        bad.append(f"outputs {_show(card['out'])} on the card, {_show(meta['out'])} on meta")
    if card.get("grad") != meta.get("grad"):
        bad.append(f"gradient {card.get('grad')} on the card, {meta.get('grad')} on meta")
    return meta, bad


def all_instances(contracts: dict[str, KernelContract] | None = None
                  ) -> list[tuple[KernelContract, Instance]]:
    """Every (contract, instance), each compiled instance once (the t and
    CE entries of distill_loss share a source, not instances)."""
    contracts = CONTRACTS if contracts is None else contracts
    return [(c, i) for name in sorted(contracts) for c in (contracts[name],)
            for i in c.instances]

