#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the FedEEC trainer (the
plain path and the simulator's scenario path), the HierFAVG-family
baselines, checkpoint and resume, the telemetry plane, the LM serving path,
the LM training path and the LM examples (BSBODP + SKR distillation between
two LMs, batched decode serving).

    python3 chip_smoke.py
    python3 chip_smoke.py --rwkv-chunks  # only phases 1-2, the chunked
                                         # rwkv6_scan and its backward at
                                         # each chunk length, and 13's
                                         # backward time
    python3 chip_smoke.py --rwkv-train   # only phases 1-2, 3's backward
                                         # checks, 11-12 for rwkv6-1.6b and
                                         # 13's backward time
    python3 chip_smoke.py --distill      # only phases 1-2 and distill_loss's
                                         # checks and times
    python3 chip_smoke.py --baselines    # only phases 1-2, 7 and 12's LM
                                         # checkpoint
    python3 chip_smoke.py --tracing      # only phases 1-2, 6's mobile_clients
                                         # run and 8
    python3 chip_smoke.py --lm-families  # only phases 1-2 and 9, 10 and 12
                                         # for gemma3-12b, nemotron-4-15b,
                                         # qwen2-moe-a2.7b, llama3-8b,
                                         # deepseek-v2-lite-16b,
                                         # zamba2-7b, whisper-small and
                                         # llava-next-mistral-7b
    python3 chip_smoke.py --latent       # only phases 1-2, the latent decode
                                         # kernel's checks and times (3, 13)
                                         # and 9 for deepseek-v2-lite-16b
    python3 chip_smoke.py --c13          # only phases 1-2 and ROADMAP C13:
                                         # rwkv6-1.6b's two-layer gradients
                                         # leaf by leaf, drawn on the CPU and
                                         # on the card
    python3 chip_smoke.py --lm-distill   # only phases 1-2, 3's distill_loss
                                         # and skr_rectify checks and times
                                         # at the LM distillation step's
                                         # shapes, and 12's distillation
                                         # path, its parity and serve_decode
    python3 chip_smoke.py --zamba2-train # only phases 1-2, 3's distill_loss
                                         # cases at zamba2-7b's loss shape,
                                         # 11-12 for zamba2-7b and 13's CE
                                         # times
    python3 chip_smoke.py --zamba2-depths  # only phases 1-2 and two zamba2-7b
                                           # training steps at each depth of
                                           # ZAMBA2_DEPTHS, peak vs traced
    python3 chip_smoke.py --analysis     # only phases 1-2 and the static
                                         # analysis against the built kernels
    python3 chip_smoke.py --sharding     # only phases 1-2 and the sharding
                                         # plane's: the NCCL mesh, the dry
                                         # run and its one-card records
                                         # against the card (the serving
                                         # steps run here for that alone)

Run from the repository root on a machine with an H100 (sm_90) and nvcc.
It imports only ``repro_torch`` (never JAX or ``repro``) and goes through
these phases, each printing its lines; any failure exits non-zero before
the result line:

1. device: name, compute capability (must be 9.0), count, nvidia-smi's name
   and power limit, and the TF32 flags the port sets;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc`` and print
   nvcc's registers / shared memory / spills per kernel, then one line per
   instance of the bf16 tensor-core attention kernel ((H, Hv) (64, 64),
   (128, 128), (256, 256), (192, 128), (112, 112)), of the 3xTF32 attention
   kernel (fp32 and bf16 at (32, 32), (64, 64), (128, 128), (256, 256),
   (192, 128), (112, 112)) and of the latent decode kernel (bf16 and fp32
   caches) with its
   registers and local (spill) bytes from ``cudaFuncGetAttributes`` (any
   local byte fails, but the 3xTF32 kernel's bf16 instance's at (256, 256),
   which only a direct launch reaches, and which is printed);
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main paths' shapes and the bench shapes (distill_loss: both
   entries, the t entry and the cross-entropy entry that takes no teacher,
   each case naming the kernels that served it (``regs`` or ``stream``
   forward, ``rows`` or ``slices`` backward), on fp32 and on bf16 logits up
   to the LM training loss's (1, 1024, 128256) (zamba2-7b's (1, 1024,
   32000) too) and the LM distillation step's fp32 (1, 128, 128256), at
   and across each
   variant's threshold, on logits off a 16-byte boundary, and the CE entry
   bit for bit against the t entry on an all-zero t; then a check that the
   CE forward allocates nothing of the logits' size; flash_attention has three kernels: the split-KV
   decode kernel for every call with one query, the tensor-core kernel for
   bf16 prefill (head_dim 64 and 128; 256 through an instance of its own
   with a TMA producer, at its edges and at gemma3-12b's global and local
   layer shapes; (192, 128), deepseek-v2-lite-16b's expanded MLA prefill,
   at its 4096-token prompt and its edges, in fp32 on the 3xTF32 kernel's
   instance of the same pair; (112, 112), zamba2-7b's shared attention
   block, at its edges and its 4096-token prompt, in fp32 on the 3xTF32
   kernel's instance; (64, 64) non-causal at its edges and at whisper-small's
   encoder (1500 frames) and cross attention (4096 queries over 1500
   frames), and causal at its decoder's 4096 tokens) and the 3xTF32
   tensor-core kernel for the rest (zamba2-7b's decode step at q_offset 0,
   63, 100 and 4095 on the decode kernel's head_dim 112 lane map;
   whisper-small's self-attention at 0, 63 and 4095 and its cross
   attention over 1500 frames, non-causal, at head_dim 64); MLA's latent decode kernel (8
   sequences, 16 heads, 576 / 512,
   against 4096 rows at q_offset 0, 50, 63, 127, 4095 and past the cache,
   one sequence at 4095, bf16 and fp32 caches, views of one buffer and two
   buffers) against ``ref.latent_decode_ref``, each case with its plan;
   each case
   names the one (and instance) that served it, at every decode case the
   3xTF32 kernel, launched directly, is held to the same bound, and rows
   that see no key (ROADMAP C8) go through each of the three and the
   empty-row kernel; rwkv6_scan
   has two: the sequential kernel for T <= 16 and the chunked scan for
   longer T, and each case names the one that served it, extreme decays
   included; its backward kernel (``Rwkv6Scan``'s, launched by autograd)
   against the plain backward on the same cases, T = 1, T = 17, w = 0
   exactly at the edges of its sub-chunks and chunks (hd 64 and 128), hd
   128 across many chunks and the training shape (2, 1024, 32, 64), every
   gradient within 1e-4 of its max
   |g|, each line naming the forward kernel that served it; skr_rectify
   has two entries: the map alone, exact, and the
   fused entry, SKR's queue pass and map in one launch, with count, head
   and q exact and Q within 1e-6, at a teacher step of the main path, four
   pairs, (4, 256, 1024), repeated labels, more rows than a chunk, and the
   LM distillation step's teacher step (1, 128, 128256, queues of 20), its
   labels over all classes or from 64), then the
   FedEEC kernels' device time (a CUDA graph of many launches between CUDA
   events) beside the plain version's, the bound and, where one PyTorch
   call computes the same function, that call's time (distill_loss's
   entries at (1, 8, 10) and at (4, 256, 2048) fp32, the latter also cold:
   rotating through inputs past the 50 MB L2, and the t entry at the LM
   distillation step's (1, 128, 128256) fp32 at beta 1.5; skr_rectify's map
   at (1, 8, 10) and (4, 256, 1024), its fused entry there and at (1, 128,
   128256), queues of 20), and SKR per
   teacher step issued eagerly as the main path issues it, beside the
   loop of torch ops it replaced and the other label check, with the torch
   ops each dispatches;
4. FedEEC: ``run_experiment("fedeec", FLConfig(), rounds=3)`` on the card,
   with the launch counters zeroed just before and read just after, each
   held to the count the trainer's ``pair_steps`` predicts (SKR: one
   launch of the fused entry a teacher step, none of the map alone);
5. FedEEC parity: the card against the CPU (the port's plain path, which
   the CPU tests hold to the JAX package) on small inputs: one student
   step's loss and gradient per model, one coalesced group's student step
   (three stacked students) per model, and one tiny FedEEC round;
6. FedEEC on the simulator, with the trainer's coalesced dispatch: the 11
   named scenarios at the gate configuration of
   ``benchmarks/tables/scenarios.json`` (4 clients, 2 edges, cnn2 edge and
   cloud, 2 rounds, no eval) on the card, each event signature held to the
   table and the fault counters of ``lossy_links`` and ``regional_outage``
   to ``BENCH_faults.json``, and ``lossy_links`` once more with serial
   dispatch forced, held to its serial signature (ROADMAP C9); then
   ``run_experiment("fedeec", FLConfig(), rounds=3,
   scenario="mobile_clients")`` at full width, with the launch counters
   zeroed before and held after to a CPU replay of the same schedule (cnn2
   at every tier; a coalesced group's launches counted once a group step),
   whose event log without evals and dispatch stats must equal the card's:
   round host s, simulated s, event counts, dispatch stats, comm bytes,
   accuracy curve and peak memory; then serial against coalesced dispatch
   at ``FLConfig()`` for ``mobile_clients`` and ``flash_crowd``: two runs
   each, driven a round at a time (serial, batched, batched, serial), with
   round host s and launches by name, the launches saved held to what the
   groups predict;
7. the baselines: ``run_experiment(name, FLConfig(), rounds=...)`` for
   ``hierfavg`` (3 rounds), then ``hiermo``, ``hierqsgd``, ``demlearn`` and
   ``fedavg`` (1 round each), cnn1 on every node, with the launch counters
   zeroed before each and held after to one launch of distill_loss's CE
   entry each way per local step (clients x rounds x local_steps x kappa1,
   ``regs`` forward, ``rows`` backward), no other kernel and no call of the
   CE entry's plain version: round host s, accuracy curve, comm bytes and
   peak memory; one local step's loss and gradient on the card against the
   CPU; the 11 named scenarios with ``hierfavg`` at the gate configuration,
   each signature held to the table; and resume on the card: ``fedeec``
   under ``lossy_links`` and ``hierfavg`` under ``regional_outage`` (the
   reference test's small config, 4 rounds, an eval every 2) run
   uninterrupted, stopped after 2 rounds with a snapshot, and resumed, the
   event log without evals and the eval times held to the uninterrupted
   run's;
8. tracing: the 11 gate scenarios of 6 again, each under a ``Tracer``
   (which takes the simulator's general pricing loop), held to the same
   table and to one item span per priced item; ``run_experiment("fedeec",
   FLConfig(), rounds=3, scenario="mobile_clients", tracer=Tracer())``
   held to 6's untraced run (the event log without evals, eval times and
   dispatch stats; the signatures printed), its Chrome trace written and
   read back through ``repro_torch.obs.report``, the categories {churn,
   dispatch, execute, item, round, eval, kernel}, the ``kernel.*`` spans
   per op equal to ``kernel_dispatch_seconds``'s observations, to
   distill_loss's forward launches and to the fused SKR launches, each
   round span within 2% or 5 ms of ``round_s``, and the traced round host
   s printed beside the untraced; one traced plain round at ``FLConfig()``
   with one ``execute`` span per work item; and ``BENCH_obs.json``'s
   contract at its configuration (metric names, the categories plus
   ``kernel``, round 0's gate). Its launches stay out of the kernels line;
9. LM serving, for llama3.2-3b, rwkv6-1.6b, gemma3-12b (40 sliding-window
   layers of 1024 keys and 8 global ones, head_dim 256, QK-norm),
   nemotron-4-15b, qwen2-moe-a2.7b (24 MoE blocks: 60 experts, top 4, 4
   shared), llama3-8b and deepseek-v2-lite-16b (a dense MLA layer and 26
   MLA + MoE ones: 64 experts, top 6, 2 shared; its prefill step on the
   tensor-core kernel's (192, 128) instance, its decode steps on the
   latent decode kernel, 27 launches each), zamba2-7b (68 mamba2 blocks,
   torch ops, and 13 occurrences of one shared attention block at head_dim
   112: 13 tensor-core launches on its (112, 112) instance at the prefill
   step, 1,664 decode launches in ``serve``), whisper-small (12 encoder
   layers over 1500 frames, 12 decoder layers each with cross attention,
   head_dim 64: 36 launches of the tensor-core kernel's (64, 64) instance
   at the prefill step, 3,072 decode launches in ``serve``, its cache's
   encoder states random as ``serve`` draws them) and llava-next-mistral-7b
   (its prefill step 2048 media rows + 2048 tokens), one after the other
   (each freed before the next), at full width and depth in
   bf16, but for the depth of six families, cut to keep the run within
   its time (``SERVE_REPEATS``: gemma3-12b 2 of 8 repeats, nemotron-4-15b,
   qwen2-moe-a2.7b, llama3-8b and llava-next-mistral-7b 8 of 32 / 24 / 32 /
   32 layers, deepseek-v2-lite-16b its head block and 8 of 26 repeats):
   ``serve(..., use_reduced=False)`` of 8 requests (64-token prompts,
   64 generated tokens, a 4096-long cache) and one ``make_prefill_step``
   call at batch 1 (4096 tokens; rwkv6's 1024), with every launch counter
   zeroed before and held after
   to the counts the layer list predicts (the prefill step's attention on
   the tensor-core kernel, gemma3-12b's 48 layers on its head_dim 256
   instance, every decode step's on the split-KV decode
   kernel, none on the 3xTF32 kernel; the prefill step's scans on the chunked
   kernel, every decode step's on the sequential one; no other kernel,
   the MoE blocks' routing and expert products included): tokens/s, ms per
   decode step, prefill-step s and peak memory; then, for each attention
   model, decode steps
   at position 4095 of a full cache of random values (gemma3-12b's local
   layers then attend to their last 1024 keys): wall ms per step
   (host clock, ending in a sync) and device ms per step (the union of
   kernel intervals under ``torch.profiler``, in a window opened by a
   marker lead-in, rerun with a doubled lead-in if every marker is lost,
   the lost count printed), with the attention kernel's share;
10. LM parity: each architecture at full width, two layers, fp32, on the
   card and on the CPU from the same parameters: 8 decode steps and one
   128-token prefill; gemma3-12b with one local and one global layer and a
   16-token window, 24 decode steps (past the window); deepseek-v2-lite-16b
   with its dense ``mla`` layer and one ``mla_moe`` (fp32: the 3xTF32
   kernel's (192, 128) instance and the latent decode kernel on an fp32
   cache); zamba2-7b at four layers, (mamba2, shared_attn) twice (the
   3xTF32 kernel's (112, 112) instance and the decode kernel at 112);
   whisper-small with two encoder and two decoder layers, decoding against
   random encoder states, its prompt with random frames; llava-next-mistral-7b
   with a prompt of 64 media rows and 64 tokens;
11. LM training: ``train_lm(arch, use_reduced=False, steps=4, batch=2,
   seq=1024, use_kernels=True)`` for llama3.2-3b then rwkv6-1.6b, full width
   and depth in bf16, with the launch counters zeroed before and held after
   to the layer list's prediction: steps x seq / loss_chunk distill_loss CE
   launches each way, none of the forward-only attention kernels, and per
   rwkv6 layer and step one chunked rwkv6_scan forward and one backward
   launch: wall s, tokens/s, loss and grad norm per step, and the peak
   memory; then one step's breakdown under ``torch.profiler`` (device busy
   ms, idle share, top kernels; the window opens with a marker lead-in,
   whose lost count is printed, and fails if it lost all of it); then
   zamba2-7b at full width and the deepest depth whose peak, traced by the
   dry run on one card (``launch.dryrun``; the table of 10-13 repeats
   printed), leaves 4 GiB of the card free (12 of 13 repeats of
   (mamba2 x 5, shared_attn) + 3 tail blocks on an H100 80GB), ``remat``
   on, the same 4 steps, held to 8 CE launches each way and nothing else
   and to the 4 GiB; with the memory allocated just before and after the
   unit's gradient is stacked, and the profiled step's device time in the
   mamba2 mixers (``record_function`` ranges around each mixer's forward
   and backward);
12. training parity: llama3.2-3b, rwkv6-1.6b at (rwkv_chunk,
   ssm_seq_chunk) (0, 0), (0, 32) and (16, 32), qwen2-moe-a2.7b (its router
   losses and the routers' gradients too), gemma3-12b (one local and
   one global layer, a 16-token window), deepseek-v2-lite-16b (``mla``
   and ``mla_moe``, its router too) and whisper-small (two encoder and two
   decoder layers, random frames: encoder, cross attention and decoder
   under autograd) and zamba2-7b (four layers, (mamba2, shared_attn)
   twice, at ssm_seq_chunk 0 and 32; the shared block's leaves' worst
   share printed), at full width, two layers,
   fp32, one ``make_train_step`` on the card and on the CPU from the same
   params and ``token_batches`` batch (loss, grad norm, every gradient
   leaf), and on the card the loss with ``use_kernels`` on against off;
   before them, the LM distillation path (``examples.train_lm_distill``):
   llama3.2-3b at full width and depth teaches llama3-8b at full width and
   8 of 32 layers (``served_config``), bf16 weights, fp32 from the logits on,
   ``run``'s 20 steps of 4 x 32 tokens over the shared 128,256-token
   vocabulary, with the launch counters zeroed before and held after to 20
   distill_loss t-entry launches each way (``stream`` forward, ``slices``
   backward), 20 of SKR's fused entry and 28 tensor-core (128, 128)
   attention launches a step (the teacher's; the student's attention is
   ``mha``): step wall ms, peak memory, losses, SKR's pushes and rectified
   rows, then one step under the profiler (device busy ms and the shares
   of SKR's fused entry, distill_loss, the teacher's attention and AdamW);
   its card-vs-CPU parity at two layers each in fp32 (the teacher's logits,
   tlogq from the card's logits and from each device's, SKR's state, the
   loss, every gradient leaf), and ``serve_decode.main(["rwkv6-1.6b"])`` on
   the card (16 sequential scan launches); then
   ``train_lm(checkpoint=)`` on llama3.2-3b reduced to two layers in bf16,
   the file read back with the port's ``load_pytree`` and held bit for bit
   to the card's params and AdamW state;
13. LM kernel times, as in 3, at the serving path's shapes, and the 3xTF32
   attention kernel, launched directly, at the prefill shape beside the
   bf16 tensor-core one and at the decode shapes beside the decode one;
   gemma3-12b's global and local attention layers (bf16, head_dim 256, a
   4096-token prompt) through the tensor-core kernel's TMA instance, and
   at a decode step through the split-KV kernel, beside
   the 3xTF32 kernel launched directly and SDPA (each SDPA call's backend
   named from the profiler); deepseek-v2-lite-16b's expanded prefill
   (1, 4096, 16/16, 192/128) on the (192, 128) instances in bf16 and fp32,
   and its latent decode kernel at q_offset 63, 127 and 4095 beside fp32
   SDPA on the same function (one kv head, keys 576 wide, values their
   first 512), with its bound (bytes) and the fp32-core and 3xTF32
   operation figures, cold at 4095 too, its split and merge passes under
   the profiler; whisper-small's attention at head_dim 64 (its encoder,
   cross and decoder attention at the prefill step on the (64, 64)
   instance, its self and cross attention at a decode step) beside SDPA;
   the 3xTF32 kernel in fp32 at the llama3.2-3b
   prefill shape, the calls it serves, beside fp32 SDPA (TF32 off), its
   3xTF32 bound and the fp32-core bound; the tensor-core kernel at the LM
   distillation teacher's (4, 32, 24/8, 128) beside SDPA; the
   sequential rwkv6_scan kernel, launched directly, at the prefill shape
   beside the chunked one, and the chunked one's three kernels' device ms
   under the profiler; the rwkv6_scan backward kernel at the training
   shape beside the plain backward, with its bound (its operations as
   3xTF32 at TF32's peak), the same operations on the fp32 cores and its
   design's floor (3xTF32 GEMMs and chunk scratch), and its three kernels
   (local, chunk_scan, grads) under the profiler; and
   distill_loss at the training shape in bf16, both entries forward and
   backward, and its CE entry at zamba2-7b's (1, 1024, 32000), beside
   ``F.cross_entropy`` on the same logits, printed on lines of their own. They come last, so that nothing the timing leaves
   allocated enters a main path's peak memory;
14. the next round of each serial and batched run of 6 under
   ``torch.profiler``: kernels in the round, device busy s and idle share
   (last, after every other profiler window), in a window opened by a
   marker lead-in, the round after in a window with twice the lead-in if
   every marker is lost, the lost count printed.

The static analysis, right after the build, in every mode of the script
(``repro_torch.analysis``, which reads source and traces on ``meta``):

- ``run_analysis()`` over ``src/repro_torch``, the AST rules and the kernel
  contracts, with no finding outside ``analysis-baseline-torch.json``;
- the contract table's mirror held to the built kernels: the build's
  report compiles as many entry functions as the table has instances, the
  card's ``shared_memory_per_block_optin`` is KRN003's limit, and for each
  instance (a line each) ``cudaFuncGetAttributes`` through its family's
  ``*_attrs`` entry, after the opt-in its launch makes, gives the mirror's
  static shared bytes, the dynamic bytes its launch passes and the opt-in's
  bytes, registers within its cap, threads within the card's most a block
  and no local bytes but where the table says why (the three instances no
  main path reaches);
- each contract shape once through its entry on the card (zeros; the
  backward too where the contract has one), its outputs' and gradient's
  shapes and dtypes held to the meta trace's, a line each.

The sharding plane:

- dry run, right after the build and before any timed phase:
  ``launch.dryrun.run_one`` for the 10 architectures x 4 input shapes on
  1x1 (the step traced on ``meta``), 16x16 and 2x16x16, a line a record as
  the reference's CLI prints, each status held to ``shape_skip_reason``,
  and the one-card table (peak, whether it fits); with them the one-card
  records of the card checks below. It is traced in a worker process a
  host core, the card hidden from them, and ends before phase 1 starts;
- mesh, between 11's training paths and zamba2-7b's: ``make_host_mesh()``
  on the card, a one-rank NCCL group on an in-process store, as (1, 1)
  over ("data", "model") and (1, 1, 1) over ("pod", "data", "model");
  ``hier_grad_mean`` and ``edge_only_mean`` over a batch-leading tree
  shaped as llama3.2-3b's parameters (full width, bf16, batch 2, 12.85
  GB), each held bit for bit to the flat ``mean(0)``;
- after zamba2-7b's training, the dry run against the card: for each case,
  the peak stats reset, one step on the card, ``max_memory_allocated``
  over what was allocated before its arguments held to the traced
  ``peak_bytes`` within 5% or 512 MiB: zamba2-7b's training step at 10, 11
  and 12 repeats (the record saying 13 does not fit), llama3.2-3b's and
  rwkv6-1.6b's, each served model's prefill step and decode step at 4095
  (measured in 9), and every input-shape pair the one-card record says
  fits, at its own batch and length, full width and depth.

It ends with its seconds in all, the count of ``profile_phases`` windows
taken and taken again (ROADMAP C14), the kernels' JSON line (distill_loss has
a row per entry and direction, each with its launches per variant;
skr_rectify a row per entry, ``skr_rectify`` the fused one), nvidia-smi's
line and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
TIMED_LAUNCHES = 200
TPU_KERNELS = {
    "distill_loss_fwd": "src/repro/kernels/distill_loss.py:53",
    "distill_loss_bwd": "src/repro/kernels/distill_loss.py:95",
    "distill_loss_fwd_ce": "src/repro/kernels/distill_loss.py:53",
    "distill_loss_bwd_ce": "src/repro/kernels/distill_loss.py:95",
    "skr_rectify": "src/repro/kernels/skr_rectify.py:33",
    "skr_rectify_map": "src/repro/kernels/skr_rectify.py:33",
    "flash_attention": "src/repro/kernels/flash_attention.py:32",
    "flash_attention_tf32x3": "src/repro/kernels/flash_attention.py:32",
    "flash_attention_decode": "src/repro/kernels/flash_attention.py:32",
    "flash_attention_sm90_h256": "src/repro/kernels/flash_attention.py:32",
    "flash_attention_sm90_192": "src/repro/kernels/flash_attention.py:32",
    "flash_attention_sm90_112": "src/repro/kernels/flash_attention.py:32",
    "flash_attention_sm90_64": "src/repro/kernels/flash_attention.py:32",
    # no Pallas kernel: the reference's absorbed MLA decode is jnp einsums
    "flash_attention_latent_decode": "src/repro/models/attention.py:319-338 (jnp einsums)",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:25",
    "rwkv6_scan_chunked": "src/repro/kernels/rwkv6_scan.py:25",
    # no Pallas kernel: the gradient XLA derives from the reference's lax.scan
    "rwkv6_scan_bwd": "src/repro/models/ssm.py:96 (XLA autodiff of the lax.scan)",
}
SOURCES = {
    "distill_loss_fwd": "src/repro_torch/csrc/distill_loss.cu",
    "distill_loss_bwd": "src/repro_torch/csrc/distill_loss.cu",
    "distill_loss_fwd_ce": "src/repro_torch/csrc/distill_loss.cu",
    "distill_loss_bwd_ce": "src/repro_torch/csrc/distill_loss.cu",
    "skr_rectify": "src/repro_torch/csrc/skr_rectify.cu",
    "skr_rectify_map": "src/repro_torch/csrc/skr_rectify.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_tf32x3": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_decode": "src/repro_torch/csrc/flash_attention_decode.cu",
    "flash_attention_sm90_h256": "src/repro_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_sm90_192": "src/repro_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_sm90_112": "src/repro_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_sm90_64": "src/repro_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_latent_decode": "src/repro_torch/csrc/flash_attention_latent_decode.cu",
    "rwkv6_scan": "src/repro_torch/csrc/rwkv6_scan.cu",
    "rwkv6_scan_chunked": "src/repro_torch/csrc/rwkv6_scan_chunked.cu",
    "rwkv6_scan_bwd": "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
}
# the kernels' JSON rows: flash_attention's three CUDA kernels each have
# one (the tensor-core kernel's at its (128, 128) instance), the
# tensor-core kernel's (256, 256) instance (TMA producer), its (192, 128)
# instance (MLA's expanded prefill), its (112, 112) instance (zamba2-7b's
# shared attention block) and its (64, 64) instance (whisper-small's
# encoder, decoder and cross attention) one each of their own, the latent
# decode kernel one, and rwkv6_scan's two kernels one each; the values are
# the keys of drive_lm_path's launches per kernel
VARIANTS = {"flash_attention": "sm90", "flash_attention_tf32x3": "tf32x3",
            "flash_attention_decode": "decode", "flash_attention_sm90_h256": "sm90_h256",
            "flash_attention_sm90_192": "sm90_192", "flash_attention_sm90_112": "sm90_112",
            "flash_attention_sm90_64": "sm90_64",
            "flash_attention_latent_decode": "latent_decode"}
RWKV_VARIANTS = {"rwkv6_scan": "seq", "rwkv6_scan_chunked": "chunked"}
# distill_loss's JSON rows per entry of ``distill_loss.variant_launches``,
# and those launches summed over the main paths' runs
DISTILL_ROWS = {"fwd": "distill_loss_fwd", "bwd": "distill_loss_bwd",
                "fwd_ce": "distill_loss_fwd_ce", "bwd_ce": "distill_loss_bwd_ce"}
MAIN_DISTILL: dict[str, int] = {}
# skr_rectify's launches per entry (the map, the fused queue pass + map)
# summed over the main paths' runs; the JSON has a row for each
MAIN_SKR: dict[str, int] = {}
SKR_ROWS = {"fused": "skr_rectify", "map": "skr_rectify_map"}


def add_variant_launches() -> None:
    """Add distill_loss's launches per entry and variant, and skr_rectify's
    per entry, since the last ``reset_launches`` to MAIN_DISTILL and
    MAIN_SKR: called right after a main path's run, where its launch counts
    are read."""
    from repro_torch.kernels.distill_loss import variant_launches
    from repro_torch.kernels.skr_rectify import variant_launches as skr_variants

    for k, n in variant_launches.items():
        MAIN_DISTILL[k] = MAIN_DISTILL.get(k, 0) + n
    for k, n in skr_variants.items():
        MAIN_SKR[k] = MAIN_SKR.get(k, 0) + n


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n== {name}  (at {time.perf_counter() - T0:.1f} s)", flush=True)


def eager_ms(fn, launches: int = TIMED_LAUNCHES) -> float:
    """Milliseconds per call of ``fn`` issued eagerly in a loop, from CUDA
    events: what a caller launching one call at a time sees, host launch
    overhead included."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def device_ms(fn, launches: int = TIMED_LAUNCHES, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls captured
    in one CUDA graph and replayed between CUDA events, so the host's
    launch overhead drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- phases


def check_device():
    import torch

    from repro_torch.device import resolve_device

    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    print(f"device: {name}  capability {cap}  count {count}")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}  "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    if cap != (9, 0):
        fail(f"needs compute capability (9, 0), got {cap}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    return dev, name, count, smi


def build_kernels():
    from repro_torch.kernels import _lib

    phase("build")
    t0 = time.perf_counter()
    path, report = _lib.build()
    _lib.lib()
    print(f"built {path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if line.startswith("==") or "Compiling entry" in line or "Used" in line or "spill" in line \
                or "Performance Loss" in line:
            print("  " + line.strip())
    if "sm_90a" not in report:
        fail("kernels were not compiled for sm_90a")
    import torch

    from repro_torch.kernels.flash_attention import (
        SM90_INSTANCES,
        TF32X3_INSTANCES,
        latent_decode_attrs,
        sm90_attrs,
        tf32x3_attrs,
    )

    for H, Hv in SM90_INSTANCES:
        regs, local = sm90_attrs(H, Hv)
        note = (" (at launch; setmaxnreg: consumers 232, producer 40)" if H == 256 else "")
        print(f"flash_attention sm90 instance (H, Hv) {(H, Hv)}: {regs} registers a "
              f"thread{note}, {local} local (spill) bytes a thread")
        if local:
            fail(f"the flash_attention sm90 instance {(H, Hv)} uses {local} local bytes")
    for dtype in (torch.float32, torch.bfloat16):
        for H, Hv in TF32X3_INSTANCES:
            regs, local = tf32x3_attrs(H, Hv, dtype)
            print(f"flash_attention tf32x3 instance {str(dtype)[6:]} (H, Hv) {(H, Hv)}: {regs} "
                  f"registers a thread, {local} local (spill) bytes a thread")
            if local and not (H == 256 and dtype == torch.bfloat16):
                fail(f"the flash_attention tf32x3 instance {dtype} {(H, Hv)} uses {local} "
                     "local bytes")
        regs, local = latent_decode_attrs(dtype)
        print(f"flash_attention latent_decode, a {str(dtype)[6:]} cache: {regs} registers a "
              f"thread, {local} local (spill) bytes a thread")
        if local:
            fail(f"the latent decode kernel for a {dtype} cache uses {local} local bytes")


ANALYSIS_PHASE = "static analysis and kernel contracts against the built kernels"


def run_static_analysis(dev) -> None:
    """The port's static analysis (``python -m repro_torch.analysis``'s run)
    clean against its baseline; the contract table's mirror of every kernel
    instance held to ``cudaFuncGetAttributes``; each contract shape through
    its entry on the card held to its meta trace. Any mismatch fails."""
    import torch

    from repro_torch.analysis import BASELINE_NAME, Baseline, run_analysis
    from repro_torch.analysis import kernel_contracts as kc
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    findings, suppressed = run_analysis(root=str(ROOT))
    new, old = Baseline.load(str(ROOT / BASELINE_NAME)).split(findings)
    print(f"run_analysis over src/repro_torch: {len(new)} finding(s), {len(old)} "
          f"grandfathered, {len(suppressed)} inline-allowed, in "
          f"{time.perf_counter() - t0:.2f} s")
    for f in new:
        print("  " + f.render())
    if new:
        fail(f"the static analysis found {len(new)} finding(s) outside {BASELINE_NAME}")
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    print(f"shared memory a block may opt in to: {optin} B on the card, KRN003's limit "
          f"{kc.DEFAULT_SMEM_LIMIT} B")
    if optin != kc.DEFAULT_SMEM_LIMIT:
        fail(f"the card's opt-in limit {optin} B is not KRN003's {kc.DEFAULT_SMEM_LIMIT} B")
    pairs = kc.all_instances()
    compiled = _lib.build()[1].count("Compiling entry function")
    print(f"the build compiled {compiled} entry functions; the contract table has "
          f"{len(pairs)} instances")
    if compiled != len(pairs):
        fail(f"{compiled} entry functions compiled, {len(pairs)} instances in the table")
    bad = []
    t0 = time.perf_counter()
    for c, inst in pairs:
        a, problems = kc.card_attrs(c, inst)
        opt = "" if inst.opt_in is None else f" opt-in {a['max_dynamic_smem']}/{inst.opt_in}"
        print(f"  {c.name} {inst.name}: regs {a['regs']} (cap {inst.reg_cap()}), local "
              f"{a['local_bytes']}, static {a['static_smem']}/{inst.static_smem}, dynamic "
              f"{a['dynamic_smem']}/{inst.dynamic_smem}{opt}, threads {inst.threads} of "
              f"{a['max_threads']}: " + ("MISMATCH " + "; ".join(problems) if problems
                                         else "ok (card/mirror)"))
        bad += [f"{c.name} {inst.name}: {p}" for p in problems]
    print(f"{len(pairs)} instances read in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    n = 0
    for name in sorted(kc.CONTRACTS):
        c = kc.CONTRACTS[name]
        for shape in c.shapes:
            want, problems = kc.card_trace(c, shape, dev)
            grad = f", gradient {kc._show([want['grad']])}" if "grad" in want else ""
            print(f"  {name}.{c.entry} at {kc._label(shape)}: {kc._show(want['out'])}{grad} "
                  + ("MISMATCH " + "; ".join(problems) if problems else "on the card as on meta"))
            bad += [f"{name} at {kc._label(shape)}: {p}" for p in problems]
            n += 1
    torch.cuda.empty_cache()
    print(f"{n} contract shapes through their entries on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    if bad:
        fail(f"{len(bad)} contract mismatch(es) against the card: " + "; ".join(bad[:5]))


def _distill_inputs(B, N, V, dev, seed=0):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((B, N, V), generator=g, device=dev) * 2.0
    t = torch.log_softmax(torch.randn((B, N, V), generator=g, device=dev), -1)
    y = torch.randint(0, V, (B, N), generator=g, device=dev)
    return z, t, y


def _unaligned(x):
    """x's values in a contiguous tensor that starts one element past a
    16-byte boundary: every row peels a head and a tail."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


# the LM distillation step's shapes (``examples.train_lm_distill`` at full
# width): its student loss's (B, N, V), B 4 x S 32 rows of the shared
# 128,256-token vocabulary; its teacher step's SKR (B, N, C, Bq); its
# teacher's attention (B, Sq, Sk, N, K, H), llama3.2-3b's prefill of 4 x 32
# tokens
DISTILL_TEACHER_SHAPE = (1, 128, 128256)
SKR_TEACHER_SHAPE = (1, 128, 128256, 20)
DISTILL_TEACHER_ATTN = (4, 32, 32, 24, 8, 128)
# (B, N, V): FedEEC's rows (V = 10), vocabularies no multiple of 4 or 8, the
# fp32 bench shape, fp32's register-layout threshold (16 KB: V = 4096) and
# bf16's (V = 8192) from both sides, llama3.2-3b's vocabulary, and the LM
# distillation step's
DISTILL_SHAPES = [(1, 8, 10), (4, 8, 10), (3, 37, 1000), (2, 33, 4095), (2, 33, 4096),
                  (2, 33, 4097), (4, 256, 2048), (2, 64, 128256), DISTILL_TEACHER_SHAPE]
DISTILL_BF16_SHAPES = [(1, 8, 10), (3, 37, 1000), (2, 5, 1003), (2, 33, 4095), (2, 33, 4096),
                       (2, 33, 4097), (2, 17, 8191), (2, 17, 8192), (2, 17, 8193),
                       (4, 256, 2048)]
# the cases also run on logits one element off a 16-byte boundary
DISTILL_UNALIGNED = {(3, 37, 1000), (2, 33, 4097), (2, 5, 1003), (2, 17, 8193)}
TRAIN_LOSS_SHAPE = (1, 1024, 128256)  # llama3.2-3b, batch 2 x loss_chunk 512 rows
ZAMBA2_LOSS_SHAPE = (1, 1024, 32000)  # zamba2-7b's, the same rows


def _distill_case(dev, B, N, V, dtype, beta, unaligned):
    """One case through each entry that computes it (the t entry; at beta
    = 0 also the CE entry, with no t), against the plain versions on the
    same inputs, and the CE entry against the t entry on an all-zero t, bit
    for bit (one template). Returns per entry (loss err, dz err, dz share
    of its bound) and the variants that served the case."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.distill_loss import (
        _bwd_variant,
        _fwd_variant,
        distill_loss_batched,
        softmax_xent_batched,
        variant_launches,
    )

    z, t, y = _distill_inputs(B, N, V, dev)
    z, t = z.to(dtype), (t if beta else torch.zeros_like(t)).to(dtype)
    if unaligned:
        # at beta = 0, t shares z's phase (the t entry's forward on 16-byte
        # loads, as the CE entry's); at beta = 1.5 it does not (scalar loads)
        z, t = _unaligned(z), (_unaligned(t) if beta == 0.0 else t)
    w = torch.randn((B, N), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    out, got = {}, {}
    for entry in ("t", "ce") if beta == 0.0 else ("t",):
        ops.reset_launches()
        zk = z.clone() if not unaligned else _unaligned(z)
        zk.requires_grad_(True)
        loss = (distill_loss_batched(zk, t, y, beta, 1.0) if entry == "t"
                else softmax_xent_batched(zk, y))
        (dz,) = torch.autograd.grad(loss, zk, w)
        served = {k: n for k, n in variant_launches.items() if n}
        want = R.distill_loss_batched_ref(z, y, t, beta, 1.0)
        want_dz = R.distill_loss_grad_ref(z, y, t, beta, 1.0, g=w)
        torch.cuda.synchronize()
        name = "" if entry == "t" else "_ce"
        rule = {f"fwd{name}:{_fwd_variant(B * N, V, dtype)[0]}": 1,
                f"bwd{name}:{_bwd_variant(V, dtype)[0]}": 1}
        if served != rule:
            fail(f"distill_loss {entry} entry at {(B, N, V)} {dtype}: served by {served}, "
                 f"the rule picks {rule}")
        e_fwd = (loss - want).abs().max().item()
        d = (dz.float() - want_dz.float()).abs()
        if dtype == torch.float32:
            bound = 1e-6 + 1e-5 * want_dz.abs()
        else:
            bound = R.distill_loss_grad_bf16_bound(want_dz.float(), z, t, beta, g=w)
        share = (d / bound).nan_to_num(0.0).max().item()  # 0 / 0: equal zeros
        ok = (loss.dtype == torch.float32 and dz.dtype == dtype
              and torch.allclose(loss, want, rtol=1e-5, atol=1e-6) and bool((d <= bound).all()))
        print(f"distill_loss {entry:2s} {str(dtype)[6:]} ({B},{N},{V}) beta={beta}"
              f"{' unaligned' if unaligned else ''} [{', '.join(served)}]: fwd max|err| "
              f"{e_fwd:.3e}  dz max|err| {d.max().item():.3e}, {share:.3f} of its bound  "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"distill_loss {entry} entry disagrees with its plain version at "
                 f"({B},{N},{V}) {dtype} beta={beta}")
        out[entry] = (e_fwd, d.max().item())
        got[entry] = (loss, dz)
    if "ce" in got and not (torch.equal(got["ce"][0], got["t"][0])
                            and torch.equal(got["ce"][1], got["t"][1])):
        fail(f"distill_loss at ({B},{N},{V}) {dtype}: the CE entry differs from the t "
             "entry on an all-zero t")
    return out


def check_distill_loss(dev):
    """Every entry and variant against its plain version, fp32 then bf16.
    fp32: forward within 1e-5 relative plus 1e-6 (sums in another order);
    gradient within 1e-6 absolute plus 1e-5 relative (a one-ulp difference
    in logZ scales each dz element by about 1e-6 of itself). bf16 logits,
    as the LM training loss feeds them to the CE entry (and at beta = 1.5
    with a bf16 teacher): the loss (fp32) as in fp32; dz (bf16) within
    ``ref.distill_loss_grad_bf16_bound``: both sides compute in fp32 and
    round once, so one bf16 ulp of |want| and nothing more at beta = 0; at
    beta = 1.5, where beta's term can cancel lw * p, also 2^-16 of that
    element's terms g beta p (|logZ| + |logp - t| + |KL|). At beta = 0 the
    CE entry must give the t entry's bits on an all-zero t. Returns the
    worst errors per JSON row."""
    import torch

    worst = dict.fromkeys(("distill_loss_fwd", "distill_loss_bwd", "distill_loss_fwd_ce",
                           "distill_loss_bwd_ce"), 0.0)
    cases = ([(s, torch.float32) for s in DISTILL_SHAPES]
             + [(s, torch.bfloat16)
                for s in DISTILL_BF16_SHAPES + [TRAIN_LOSS_SHAPE, ZAMBA2_LOSS_SHAPE]])
    for (B, N, V), dtype in cases:
        for unaligned in (False, True) if (B, N, V) in DISTILL_UNALIGNED else (False,):
            for beta in (0.0, 1.5):
                for entry, (e_fwd, e_bwd) in _distill_case(dev, B, N, V, dtype, beta,
                                                           unaligned).items():
                    sfx = "" if entry == "t" else "_ce"
                    worst["distill_loss_fwd" + sfx] = max(worst["distill_loss_fwd" + sfx],
                                                          e_fwd)
                    worst["distill_loss_bwd" + sfx] = max(worst["distill_loss_bwd" + sfx],
                                                          e_bwd)
        torch.cuda.empty_cache()
    return worst


def check_ce_allocates_no_teacher(dev):
    """The CE entry's forward at the training shape allocates its loss,
    stats and int32 labels, and no (N, V) tensor."""
    import torch

    from repro_torch.kernels.distill_loss import softmax_xent_batched

    B, N, V = TRAIN_LOSS_SHAPE
    z, _, y = _distill_inputs(B, N, V, dev)
    z = z.bfloat16().requires_grad_(True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss = softmax_xent_batched(z, y)
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    print(f"softmax_xent forward at {TRAIN_LOSS_SHAPE} bf16: {grew} bytes allocated "
          f"(one (N, V) bf16 tensor is {z.numel() * 2})")
    if grew >= z.numel() * 2 // 8:
        fail("the CE entry's forward allocated a tensor of the logits' size")
    del loss, z


def check_skr_rectify(dev):
    """The map exact: the same division and product per element on both
    sides. The fused entry (queue pass + map): count, head and q exact (q
    only stores copies of p_c); Q within 1e-6 absolute, because the kernel
    sums a queue in slot order and the plain version with ``torch.sum``.
    Returns the largest error of each entry."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.skr_rectify import skr_process_batched, skr_rectify_batched

    for B, N, C in [(1, 8, 10), (4, 8, 10), (4, 256, 1024)]:
        probs, labels, qbar, counts = _skr_inputs(B, N, C, dev)
        got = skr_rectify_batched(probs, labels, qbar, counts)
        want = R.skr_rectify_batched_ref(probs, labels, qbar, counts)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"skr_rectify [map] ({B},{N},{C}): max|err| {err:.3e}  "
              f"{'exact' if torch.equal(got, want) else 'MISMATCH'}")
        if not torch.equal(got, want):
            fail(f"skr_rectify is not exact at ({B},{N},{C})")
    worst = 0.0
    # (B, N, C, Bq, classes the labels come from): the main path's teacher
    # step, four pairs, the bench shape, labels from 2 classes (later rows
    # see earlier pushes, heads wrap), more rows than a chunk of 1024, and
    # the LM distillation step's teacher step (128 rows of 128,256 classes,
    # labels over all of them or from 64, every class's queue partly full,
    # so that Eq. 31 fires)
    for B, N, C, Bq, classes in [(1, 8, 10, 20, None), (4, 8, 10, 20, None),
                                 (4, 256, 1024, 20, None), (2, 64, 10, 4, 2),
                                 (2, 1500, 10, 20, 3), (*SKR_TEACHER_SHAPE, None),
                                 (*SKR_TEACHER_SHAPE, 64)]:
        ins = _skr_state(B, N, C, Bq, dev, classes)
        got = skr_process_batched(*ins)
        want = R.skr_process_batched_ref(*ins)
        torch.cuda.synchronize()
        err = (got[0] - want[0]).abs().max().item()
        same_state = all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
        differ = int((got[0] != want[0]).sum())
        pushes = int((ins[0].argmax(-1) == ins[1]).sum())
        rectified = int((got[0] != ins[0]).any(-1).sum())
        print(f"skr_rectify [fused] ({B},{N},{C}, Bq {Bq}): Q max|err| {err:.3e} "
              f"({differ} of {got[0].numel()} elements differ)  count/head/q "
              f"{'exact' if same_state else 'MISMATCH'}  rows pushed {pushes}, "
              f"rectified {rectified}")
        if not same_state:
            fail(f"skr_rectify's fused entry: the queue state differs at ({B},{N},{C},{Bq})")
        if err > 1e-6:
            fail(f"skr_rectify's fused entry: Q max|err| {err:.3e} > 1e-6 at ({B},{N},{C},{Bq})")
        worst = max(worst, err)
    _lib.raise_faults(dev)  # no fault flagged
    # a fault reaches the host through the pinned words: raised at the next
    # label check on the card, once
    probs, labels, *state = _skr_state(1, 8, 10, 20, dev)
    bad = labels.clone()
    bad[0, 5] = 10
    skr_process_batched(probs, bad, *state)
    try:
        _lib.check_labels("distill_loss", labels, 10)
    except ValueError as e:
        print(f"skr_rectify [fused] an out-of-range label raised at the next label check: {e}")
    else:
        fail("skr_rectify's fused entry: an out-of-range label was not reported")
    _lib.raise_faults(dev)
    return {"skr_rectify": worst, "skr_rectify_map": 0.0}


def _skr_inputs(B, N, C, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    probs = torch.softmax(torch.randn((B, N, C), generator=g, device=dev) * 2, -1)
    labels = torch.randint(0, C, (B, N), generator=g, device=dev)
    qbar = torch.rand((B, C), generator=g, device=dev) * 0.8 + 0.1
    counts = torch.randint(0, 3, (B, C), generator=g, device=dev, dtype=torch.int32)
    return probs, labels, qbar, counts


def _skr_state(B, N, C, Bq, dev, classes=None):
    """A teacher step's probs and int64 labels (from ``classes`` classes if
    given) and a partly filled queue state with heads anywhere."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    labels = torch.randint(0, classes or C, (B, N), generator=g, device=dev)
    z = torch.randn((B, N, C), generator=g, device=dev) * 2
    # about half the rows correctly attributed, so that they push
    boost = torch.rand((B, N, 1), generator=g, device=dev) < 0.5
    z.scatter_add_(-1, labels[..., None], boost * 6.0)
    probs = torch.softmax(z, -1)
    q = torch.rand((B, C, Bq), generator=g, device=dev) * 0.8 + 0.1
    count = torch.randint(0, Bq + 1, (B, C), generator=g, device=dev, dtype=torch.int32)
    head = torch.randint(0, Bq, (B, C), generator=g, device=dev, dtype=torch.int32)
    return probs, labels, q, count, head


def _attn_inputs(B, Sq, Sk, N, K, H, dtype, dev, seed=0, Hv=None):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).mul_(0.5).to(dtype)
               for shape in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, Hv or H)))
    return q, k, v


FLASH_CASES = [
    # the sweep of tests/test_kernels.py: (B, Sq, Sk, N, K, H, causal, window)
    (2, 32, 32, 4, 2, 32, True, 0),
    (1, 64, 64, 8, 8, 64, True, 0),
    (2, 32, 32, 4, 1, 32, True, 8),
    (1, 16, 64, 4, 2, 32, True, 0),
    (2, 24, 24, 2, 2, 128, False, 0),
    # a window over a kv length that is no tile multiple, and H = 256
    (2, 40, 100, 4, 2, 64, True, 24),
    (1, 17, 33, 2, 1, 256, True, 0),
    # the head_dim 256 instance's edges in bf16 at gemma3-12b's G = 2
    # (fp32 on the 3xTF32 kernel): Sq * G no multiple of 128; Sk no multiple
    # of 64 at q_offset 60; a window across tile edges; non-causal; G = 3
    (1, 77, 77, 4, 2, 256, True, 0),
    (2, 40, 100, 4, 2, 256, True, 0),
    (1, 300, 300, 4, 2, 256, True, 70),
    (1, 96, 160, 8, 4, 256, False, 0),
    (2, 77, 77, 6, 2, 256, True, 0),
    # the tensor-core kernel's edges in bf16 (128 rows, 64 keys a tile):
    # Sq * G no multiple of 128; Sk no multiple of 64 at q_offset 60; a
    # window across tile edges; non-causal at G = 4; H = 64 at G = 1
    (1, 77, 77, 24, 8, 128, True, 0),
    (2, 40, 100, 6, 2, 128, True, 0),
    (1, 200, 200, 8, 2, 64, True, 70),
    (1, 96, 160, 8, 2, 128, False, 0),
    (2, 300, 300, 4, 4, 64, True, 0),
    # the (112, 112) instances' edges (rows of 14 units in 128-wide tiles;
    # 32-key tiles at fp32): Sq * G no multiple of 128, Sk no multiple of 64
    # at q_offset 60, a window across tile edges, non-causal at G = 2, and
    # zamba2-7b's parity prompt (32 heads, MHA)
    (1, 77, 77, 4, 4, 112, True, 0),
    (2, 40, 100, 4, 2, 112, True, 0),
    (1, 200, 200, 8, 8, 112, True, 70),
    (1, 96, 160, 8, 4, 112, False, 0),
    (1, 128, 128, 32, 32, 112, True, 0),
    # the (64, 64) instance non-causal, as whisper-small's encoder and cross
    # attention run it: Sq * G no multiple of 128 with Sk no multiple of 64
    # (G = 1, 3), and Sq > Sk with no causal clip of the key range
    (1, 77, 100, 12, 12, 64, False, 0),
    (2, 300, 70, 6, 2, 64, False, 0),
    (1, 200, 36, 12, 12, 64, False, 0),
    # the LM distillation step's teacher prefill (llama3.2-3b, 4 x 32
    # tokens): every 128-row query tile partial, one 64-key tile
    (*DISTILL_TEACHER_ATTN, True, 0),
]
# the split-KV decode kernel's edges, one query against the cache
# (B, Sk, N, K, H, causal, window, q_offset): G in {1, 3, 4, 8, 16}, every
# head_dim, several splits whose last is short, windows inside one split
# and across splits, a query past the cache's end, non-causal
DECODE_CASES = [
    (2, 300, 8, 8, 32, True, 0, 299),
    (2, 700, 6, 2, 64, True, 0, 650),
    (1, 1000, 4, 1, 128, True, 100, 900),
    (1, 1500, 16, 2, 256, True, 0, 1499),
    (1, 600, 24, 8, 128, True, 0, 700),
    (1, 1200, 8, 2, 128, True, 700, 1100),
    (2, 300, 4, 2, 32, False, 0, 5),
    (1, 520, 16, 1, 64, True, 24, 400),
    (1, 520, 16, 1, 64, True, 0, 519),
    # head_dim 112: a key row on 16 lanes (bf16; 32 in fp32), the last 2
    # (4) idle; several splits, a window, G = 2
    (1, 700, 4, 2, 112, True, 0, 650),
    (2, 1000, 8, 8, 112, True, 100, 900),
    # head_dim 64 non-causal at G = 1, as whisper-small's cross attention
    # runs it: one split (a range under 256 keys), several splits whose last
    # is short, and a query offset the mask ignores
    (8, 200, 12, 12, 64, False, 0, 0),
    (2, 1100, 12, 12, 64, False, 0, 0),
    (1, 700, 6, 2, 64, False, 0, 3),
]
# ROADMAP C8, rows that see no key (a window that ends before the keys do),
# through each of the three kernels and then the empty-row kernel:
# (B, Sq, Sk, N, K, H, causal, window, q_offset)
C8_CASES = [
    (2, 1, 33, 6, 2, 64, True, 8, 100),  # decode: the plan has no split
    (1, 64, 64, 8, 2, 32, True, 8, 40),  # tf32x3 (fp32 below; bf16 at H 32 too)
    (1, 128, 100, 24, 8, 128, True, 16, 40),  # sm90 in bf16, tf32x3 in fp32
    (1, 128, 100, 4, 2, 256, True, 16, 40),  # sm90's H 256 instance in bf16
    (1, 64, 64, 8, 2, 64, False, 8, 40),  # non-causal
    (1, 128, 100, 4, 4, 112, True, 16, 40),  # sm90's (112, 112) in bf16, tf32x3 in fp32
]
# deepseek-v2-lite-16b's expanded MLA prefill (src/repro/configs/
# deepseek_v2_lite_16b.py: 16 heads, q and k 128 nope + 64 rope, v 128), at
# the (192, 128) instances of the tensor-core and 3xTF32 kernels: its
# 4096-token prompt, the parity's 128-token prompt, and the instance's edges
# (Sq * G no multiple of 128; Sk no multiple of 64 at q_offset 60;
# non-causal at G 4): (B, Sq, Sk, N, K, H, causal, window), Hv = MLA_HV
MLA_HV = 128
MLA_PREFILL = (1, 4096, 4096, 16, 16, 192)
MLA_FLASH_CASES = [
    (*MLA_PREFILL, True, 0),
    (1, 128, 128, 16, 16, 192, True, 0),
    (1, 77, 77, 16, 16, 192, True, 0),
    (2, 40, 100, 16, 16, 192, True, 0),
    (1, 96, 160, 4, 1, 192, False, 0),
]
# its absorbed decode, one fp32 query a sequence and head against the
# latent cache of 512 + 64 values a row: (B, S, N, q_offset), the serving
# batch against its 4096-row cache at serve's first and last q_offset (0
# and 127: splits of 64 keys, the value columns across blocks), 63, a
# range that ends inside an iteration (50), a full cache (16 splits) and
# past it; one sequence (16 splits, 4 value-column groups), a short cache,
# and 5 heads
LATENT_CASES = [(8, 4096, 16, 63), (8, 4096, 16, 4095), (8, 4096, 16, 127),
                (8, 4096, 16, 0), (8, 4096, 16, 50), (8, 4096, 16, 5000), (1, 4096, 16, 4095),
                (2, 300, 16, 100), (3, 1000, 5, 777)]
# the cases also run on two buffers in place of views of one: (case, dtype)
LATENT_TWO_BUFFERS = [((8, 4096, 16, 4095), "bfloat16"), ((8, 4096, 16, 127), "bfloat16"),
                      ((8, 4096, 16, 127), "float32")]
LATENT_TIMED = (63, 127, 4095)  # serve's middle and last q_offset, a full cache
LATENT_COLD_COPIES = 3  # caches rotated for a cold-L2 time: 3 x 37.7 MB past the 50 MB L2
LATENT_DIMS = (512, 64)
MLA_SCALE = 192**-0.5  # (qk_nope_dim + qk_rope_dim)^-0.5, the reference's
FLASH_PREFILL = (1, 4096, 4096, 24, 8, 128)  # llama3.2-3b, one 4096-token prompt
# gemma3-12b's attention layers at one 4096-token prompt
# (src/repro/configs/gemma3_12b.py: 16 q heads over 8 kv heads, head_dim
# 256), global (causal) and local (a 1024-key sliding window, 40 of its 48
# layers), and at a decode step of the serving batch against its 4096-long
# cache
GEMMA3_PREFILL = (1, 4096, 4096, 16, 8, 256)
GEMMA3_DECODE = (8, 1, 4096, 16, 8, 256)
GEMMA3_WINDOW = 1024
FLASH_DECODE = (8, 1, 4096, 24, 8, 128)  # 8 requests against a 4096-long cache
# zamba2-7b's shared attention block (src/repro/configs/zamba2_7b.py: 32
# heads, MHA, head_dim 112) at its 4096-token prefill step and at a decode
# step of the serving batch against its 4096-long cache: q_offset 0, 63
# (one 64-key step of the decode kernel), 100 (a range that ends inside a
# step) and 4095
ZAMBA2_PREFILL = (1, 4096, 4096, 32, 32, 112)
ZAMBA2_DECODE = (8, 1, 4096, 32, 32, 112)
ZAMBA2_DECODE_OFFSETS = (0, 63, 100, 4095)
# whisper-small (src/repro/configs/whisper_small.py: 12 heads of 64, MHA,
# 1500 encoder frames) at its 4096-token prefill step, in the tensor-core
# kernel's (64, 64) instance: the encoder's self-attention (non-causal,
# 1500 frames: Sq * G = 1500 ends 92 rows into a 128-row tile, Sk 28 keys
# into a 64-key tile), the decoder's cross attention over the frames
# (non-causal, Sq > Sk) and its causal self-attention; and at a decode
# step of the serving batch, its self-attention against the 4096-long
# cache (q_offset 0, 63, 4095) and its cross attention over the frames
# (non-causal: _decode_plan's 6 splits of 256 keys, the last 220)
WHISPER_ENCODER = (1, 1500, 1500, 12, 12, 64)
WHISPER_CROSS = (1, 4096, 1500, 12, 12, 64)
WHISPER_SELF = (1, 4096, 4096, 12, 12, 64)
WHISPER_DECODE = (8, 1, 4096, 12, 12, 64)
WHISPER_CROSS_DECODE = (8, 1, 1500, 12, 12, 64)
# (B, T, H, hd, extreme): T <= 16 runs the sequential kernel, longer T the
# chunked scan (ragged last chunks, many chunks, hd 128); extreme puts
# w = 1e-30 at every 7th step and w = 1 in half the rows of every 5th
RWKV_CASES = [(2, 32, 4, 16, False), (1, 40, 2, 32, False), (3, 16, 1, 64, False),
              (2, 1000, 32, 64, False), (1, 65, 4, 16, False), (1, 129, 2, 128, False),
              (1, 300, 4, 64, True), (2, 13, 2, 32, True)]
RWKV_PREFILL = (1, 1024, 32, 64)  # rwkv6-1.6b, one 1024-token prompt
RWKV_DECODE = (8, 1, 32, 64)  # 8 requests, one step
RWKV_TRAIN = (2, 1024, 32, 64)  # rwkv6-1.6b, a training batch of 2 x 1024 tokens
# the backward's cases beyond RWKV_CASES: T = 1, T = 17 (one sub-chunk and a
# ragged second), w = 0 exactly ("zero": at the first and last step of
# every sub-chunk and chunk) across chunks at hd 64 and 128, hd 128 across
# many chunks, and the training shape
RWKV_GRAD_CASES = RWKV_CASES + [(3, 1, 4, 16, False), (2, 17, 4, 32, True),
                                (2, 130, 4, 64, "zero"), (1, 200, 2, 128, False),
                                (1, 75, 2, 128, "zero"), (*RWKV_TRAIN, False)]


BF16_ULP = 2.0**-7  # one bf16 ulp of x is at most 2^-7 |x|


def check_flash_attention(dev):
    """fp32 within 3e-5 (the JAX kernel tests' bound: fp32 sums in another
    order). bf16 within one bf16 ulp of each output element, 2^-7 |want|
    plus 1e-6: both sides compute in fp32 and round once, so they differ
    by at most the one rounding step (the JAX tests' 2e-2 is 20-300x
    looser than that at the main path's shapes, whose outputs are about
    0.01). The prefill and decode shapes also run in fp32 at 3e-5, where
    a dropped or misread kv tile of the 4096-key walk (about 1e-3) fails.
    gemma3-12b's global and local layer shapes run in bf16, through the
    tensor-core kernel's head_dim 256 instance; zamba2-7b's (head_dim 112:
    the tensor-core kernel's (112, 112) instance, the decode kernel's lane
    map with idle lanes, the 3xTF32 kernel's (112, 112) instance) at its
    4096-token prefill and its decode step at q_offset 0, 63, 100 (a range
    that ends inside a 64-key step) and 4095, in both dtypes; whisper-small's
    (head_dim 64, MHA: the tensor-core kernel's (64, 64) instance
    non-causal over 1500 encoder frames and across them from 4096 queries,
    causal at 4096; the decode kernel at H 64 against a 4096-long cache at
    q_offset 0, 63 and 4095, and non-causal over the 1500 frames), in both
    dtypes. Each case names the kernel
    that served it, and fails unless that is the one ``_variant`` picks (and,
    for the bf16 tensor-core kernel, the instance of its head_dim). At every
    decode case (one query) the 3xTF32 kernel, which the wrapper does not
    pick there, is also launched directly on the same inputs and held to
    the same bound. Returns the worst error per JSON row (VARIANTS)."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import (
        _has_empty_rows,
        _variant,
        flash_attention,
        sm90_launches,
        variant_launches,
    )

    both = (torch.float32, torch.bfloat16)
    cases = [(c, dt) for c in FLASH_CASES for dt in both]
    cases += [((*FLASH_PREFILL, True, 0), dt, 0) for dt in both]
    cases += [((*GEMMA3_PREFILL, True, w), torch.bfloat16, 0) for w in (0, GEMMA3_WINDOW)]
    cases += [((*FLASH_DECODE, True, 0), dt, off) for dt in both for off in (0, 63, 4095)]
    cases += [((*ZAMBA2_PREFILL, True, 0), dt, 0) for dt in both]
    cases += [((*ZAMBA2_DECODE, True, 0), dt, off) for dt in both
              for off in ZAMBA2_DECODE_OFFSETS]
    cases += [((*GEMMA3_DECODE, True, w), dt, off) for dt in both
              for w in (0, GEMMA3_WINDOW) for off in (63, 4095)]
    cases += [((*shape, causal, 0), dt, 0) for dt in both
              for shape, causal in ((WHISPER_ENCODER, False), (WHISPER_CROSS, False),
                                    (WHISPER_SELF, True))]
    cases += [((*WHISPER_DECODE, True, 0), dt, off) for dt in both for off in (0, 63, 4095)]
    cases += [((*WHISPER_CROSS_DECODE, False, 0), dt, 0) for dt in both]
    cases += [((B, 1, Sk, N, K, H, causal, window), dt, off)
              for B, Sk, N, K, H, causal, window, off in DECODE_CASES for dt in both]
    cases += [(c[:8], dt, c[8]) for c in C8_CASES for dt in both]
    # deepseek-v2-lite-16b's (192, 128) instances, and a row that sees no key
    # there (the empty-row kernel writes v's 128 columns)
    cases += [(c, dt, None, MLA_HV) for c in MLA_FLASH_CASES for dt in both]
    cases += [((1, 128, 100, 16, 16, 192, True, 16), dt, 40, MLA_HV) for dt in both]
    worst = dict.fromkeys(VARIANTS, 0.0)
    row_of = {v: k for k, v in VARIANTS.items()}

    def held(tag, got, want, dtype):
        diff = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            tol = BF16_ULP * want.float().abs() + 1e-6
        else:
            tol = torch.full_like(diff, 3e-5)
        err, share = diff.max().item(), (diff / tol).max().item()
        ok = got.dtype == dtype and share <= 1.0
        print(f"  [{tag}]: max|err| {err:.3e}, {share:.3f} of the bound, max|want| "
              f"{want.float().abs().max().item():.3e}  {'ok' if ok else 'MISMATCH'}")
        return err, ok

    for case in cases:
        (B, Sq, Sk, N, K, H, causal, window), dtype = case[0], case[1]
        qo = case[2] if len(case) > 2 and case[2] is not None else (Sk - Sq if causal else 0)
        Hv = case[3] if len(case) > 3 else H
        q, k, v = _attn_inputs(B, Sq, Sk, N, K, H, dtype, dev, Hv=Hv)
        before, h_before = dict(variant_launches), dict(sm90_launches)
        empty_before = _lib.launches["flash_attention_empty_rows"]
        got = flash_attention(q, k, v, causal=causal, window=window, q_offset=qo)
        served = [n for n in variant_launches if variant_launches[n] > before[n]]
        instances = [h for h in sm90_launches if sm90_launches[h] > h_before[h]]
        empty = _lib.launches["flash_attention_empty_rows"] - empty_before
        variant = _variant(dtype, Sq, H, Hv)
        row = row_of[{256: "sm90_h256", 192: "sm90_192", 112: "sm90_112",
                      64: "sm90_64"}.get(H, "sm90") if variant == "sm90" else variant]
        want = R.flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=qo)
        torch.cuda.synchronize()
        print(f"flash_attention {(B, Sq, Sk, N, K, H)}" + (f" Hv {Hv}" if Hv != H else "")
              + f" causal={causal} window={window} q_offset={qo} {str(dtype)[6:]}")
        err, ok = held("+".join(served + [f"{h}" for h in instances]
                                + ["empty_rows"] * empty), got, want, dtype)
        worst[row] = max(worst[row], err)
        if served != [variant]:
            fail(f"flash_attention at {case}: served by {served}, the rule picks {variant}")
        if instances != ([(H, Hv)] if variant == "sm90" else []):
            fail(f"flash_attention at {case}: sm90 instances {instances} launched")
        if empty != int(_has_empty_rows(Sq, Sk, qo, causal, window)):
            fail(f"flash_attention at {case}: {empty} empty-row launches")
        if not ok:
            fail(f"flash_attention disagrees with its plain version at {case}")
        if Sq == 1 and not empty:
            out = torch.empty_like(q)
            _lib.launch("flash_attention", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, Sq, Sk, N, K, H, H, int(dtype == torch.bfloat16),
                        int(causal), window, qo, Sk, float(H**-0.5))
            torch.cuda.synchronize()
            err, ok = held("tf32x3, launched directly", out, want, dtype)
            worst["flash_attention_tf32x3"] = max(worst["flash_attention_tf32x3"], err)
            if not ok:
                fail(f"the tf32x3 flash_attention kernel disagrees with its plain version "
                     f"at {case}")
            del out
        del q, k, v, got, want
    return worst


def _latent_inputs(B, S, N, dtype, dev, seed=0, two_buffers=False):
    """fp32 q (B, 1, N, 576) and the cache's c_kv (B, S, 512) and k_rope
    (B, S, 64) in ``dtype``: views of one (B, S, 576) buffer, as
    ``init_mla_cache`` makes them, or two buffers."""
    import torch

    L, Rd = LATENT_DIMS
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, N, L + Rd), generator=g, device=dev).mul_(0.5)
    kv = torch.randn((B, S, L + Rd), generator=g, device=dev).mul_(0.5).to(dtype)
    if two_buffers:
        return q, kv[..., :L].contiguous(), kv[..., L:].contiguous()
    return q, kv[..., :L], kv[..., L:]


def check_latent_decode(dev):
    """MLA's latent decode kernel against its plain version
    (``ref.latent_decode_ref``) on the same inputs, at ``LATENT_CASES``
    with a bf16 and an fp32 cache (views of one buffer; the cases of
    ``LATENT_TWO_BUFFERS`` also with two buffers), scale 192^-0.5: within
    3e-5 (the kernel's split products are fp32-accurate; q is never
    rounded). Each case launches the kernel once and no other attention
    kernel, and prints its plan (chunk, splits, value-column groups).
    Returns the worst error."""
    import torch

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import _latent_plan, latent_decode, variant_launches

    worst = 0.0
    cases = [(c, dt, False) for c in LATENT_CASES for dt in (torch.bfloat16, torch.float32)]
    cases += [(c, getattr(torch, dt), True) for c, dt in LATENT_TWO_BUFFERS]
    for (B, S, N, qo), dtype, two in cases:
        q, ckv, krope = _latent_inputs(B, S, N, dtype, dev, seed=qo, two_buffers=two)
        before = dict(variant_launches)
        got = latent_decode(q, ckv, krope, scale=MLA_SCALE, q_offset=qo)
        served = {n: variant_launches[n] - before[n] for n in variant_launches
                  if variant_launches[n] > before[n]}
        want = R.latent_decode_ref(q, ckv, krope, scale=MLA_SCALE, q_offset=qo)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        ok = got.dtype == torch.float32 and got.shape == want.shape and err <= 3e-5
        print(f"latent_decode q {(B, 1, N, 576)} cache {(B, S)} {str(dtype)[6:]}"
              f"{' (two buffers)' if two else ''} q_offset={qo} [{'+'.join(served)}, plan "
              f"{_latent_plan(B, S, qo)}]: "
              f"max|err| {err:.3e}, bound 3e-5, max|want| {want.abs().max().item():.3e}  "
              f"{'ok' if ok else 'MISMATCH'}")
        if served != {"latent_decode": 1}:
            fail(f"latent_decode at {(B, S, N, qo)}: launches {served}")
        if not ok:
            fail(f"the latent decode kernel disagrees with its plain version at "
                 f"{(B, S, N, qo)} {dtype}")
        del q, ckv, krope, got, want
    return worst


def _rwkv_inputs(B, T, H, hd, dev, seed=0):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    shp = (B, T, H, hd)
    r, k, v = (torch.randn(shp, generator=g, device=dev) * 0.3 for _ in range(3))
    w = torch.sigmoid(torch.randn(shp, generator=g, device=dev))
    u = torch.randn((H, hd), generator=g, device=dev) * 0.3
    s0 = torch.randn((B, H, hd, hd), generator=g, device=dev) * 0.1
    return r, k, v, w, u, s0


def _extreme_w(w):
    w = w.clone()
    w[:, ::7] = 1e-30
    w[:, 3::5, :, ::2] = 1.0
    return w


def check_rwkv6_scan(dev):
    """y and the final state within 3e-5 (fp32 sums in another order), each
    case through the kernel ``_variant`` picks, which the line names; the
    worst error per variant."""
    import torch

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rwkv6_scan import _variant, rwkv6_scan, variant_launches

    worst = dict.fromkeys(variant_launches, 0.0)
    for B, T, H, hd, extreme in RWKV_CASES + [(*RWKV_PREFILL, False), (*RWKV_DECODE, False)]:
        r, k, v, w, u, s0 = _rwkv_inputs(B, T, H, hd, dev)
        if extreme:
            w = _extreme_w(w)
        before = dict(variant_launches)
        y, sT = rwkv6_scan(r, k, v, w, u, s0)
        served = [n for n in variant_launches if variant_launches[n] > before[n]]
        yr, sTr = R.rwkv6_scan_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        ey, es = (y - yr).abs().max().item(), (sT - sTr).abs().max().item()
        variant = _variant(T)
        worst[variant] = max(worst[variant], ey, es)
        ok = ey <= 3e-5 and es <= 3e-5 and bool(torch.isfinite(y).all())
        print(f"rwkv6_scan {(B, T, H, hd)}{' extreme w' if extreme else ''} [{'+'.join(served)}]: "
              f"y max|err| {ey:.3e}  state max|err| {es:.3e}  {'ok' if ok else 'MISMATCH'}")
        if served != [variant]:
            fail(f"rwkv6_scan at {(B, T, H, hd)}: served by {served}, the rule picks {variant}")
        if not ok:
            fail(f"rwkv6_scan disagrees with its plain version at {(B, T, H, hd)}")
    return worst


def _zero_w(w):
    """w = 0 exactly at the first and last step of every sub-chunk (so of
    every chunk too): the state is wiped at each edge of the backward's
    blocks."""
    w = w.clone()
    w[:, ::16] = 0.0
    w[:, 15::16] = 0.0
    return w


def _rwkv_cotangents(B, T, H, hd, dev, zero_dsT=False):
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn((B, T, H, hd), generator=g, device=dev)
    dsT = torch.randn((B, H, hd, hd), generator=g, device=dev)
    return dy, dsT * (not zero_dsT)


GRAD_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def check_rwkv6_scan_grad(dev):
    """The backward kernel through autograd (``Rwkv6Scan``) against the plain
    backward ``ref.rwkv6_scan_grad_ref`` on the same inputs and random
    cotangents dy and dsT (dsT = 0 at the first case): every gradient
    within 1e-4 of that input's max |g| (the training parity's rule: fp32
    sums in other orders) and finite, extreme decays (1e-30 and 1) included.
    Each line names the forward kernel that served the case and the
    backward launches (one a call). Returns the worst max |err|."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rwkv6_scan import _variant, rwkv6_scan, variant_launches

    worst = 0.0
    for n, (B, T, H, hd, extreme) in enumerate(RWKV_GRAD_CASES):
        ins = list(_rwkv_inputs(B, T, H, hd, dev))
        if extreme == "zero":
            ins[3] = _zero_w(ins[3])
        elif extreme:
            ins[3] = _extreme_w(ins[3])
        dy, dsT = _rwkv_cotangents(B, T, H, hd, dev, zero_dsT=n == 0)
        leaves = [t.clone().requires_grad_(True) for t in ins]
        before, bwd0 = dict(variant_launches), _lib.launches["rwkv6_scan_bwd"]
        y, sT = rwkv6_scan(*leaves)
        got = torch.autograd.grad((y, sT), leaves, (dy, dsT))
        served = [k for k in variant_launches if variant_launches[k] > before[k]]
        bwd = _lib.launches["rwkv6_scan_bwd"] - bwd0
        want = R.rwkv6_scan_grad_ref(*ins, dy, dsT)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in zip(want, got)]
        shares = [e / max(a.abs().max().item(), 1e-30) for e, a in zip(errs, want)]
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        ok = max(shares) <= 1e-4 and finite
        worst = max(worst, *errs)
        label = {"zero": " w = 0 at sub-chunk edges", True: " extreme w", False: ""}[extreme]
        print(f"rwkv6_scan backward {(B, T, H, hd)}{label}"
              f"{' dsT = 0' if n == 0 else ''} [forward {'+'.join(served)}, backward x{bwd}]: "
              + ", ".join(f"{k} {sh:.2e}" for k, sh in zip(GRAD_NAMES, shares))
              + f" of max|g|; max|err| {max(errs):.3e}  {'ok' if ok else 'MISMATCH'}")
        if served != [_variant(T)] or bwd != 1:
            fail(f"rwkv6_scan at {(B, T, H, hd)}: forward {served}, {bwd} backward launches")
        if not ok:
            fail(f"the rwkv6_scan backward kernel disagrees with the plain backward at "
                 f"{(B, T, H, hd)}")
        del ins, leaves, y, sT, got, want
    return worst


def _timed(name, tag, shape, kernel, plain, library, nbytes, ops,
           ops_per_s=FP32_OPS_PER_S, launches=TIMED_LAUNCHES):
    """Time one kernel against its plain version (and the library call, if
    any) on the same inputs; print the line and return the JSON fields."""
    ms, eager = device_ms(kernel, launches), eager_ms(kernel, launches)
    plain_ms = device_ms(plain, launches)
    library_ms = device_ms(library, launches) if library is not None else None
    b, by = bound_ms(nbytes, ops, ops_per_s)
    print(f"{name} {tag} {shape}: kernel {ms:.5f} ms device ({eager:.5f} ms eager)  "
          f"plain {plain_ms:.5f} ms  bound {b:.6f} ms ({by})"
          + (f"  library {library_ms:.5f} ms" if library_ms is not None else ""))
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=library_ms)


COLD_COPIES = 8  # inputs rotated through for a cold-L2 time: 8 x 8.4 MB of z at (4, 256, 2048)


def _distill_bounds(entry, direction, n, V, itemsize):
    """Bytes and fp32 operations an entry must move and do: z (and t for
    the t entry) read once, dz written once; labels, stats, loss and the
    cotangent once (16 bytes a row either way); the operations as the
    kernel's meta entry declares them (``distill_loss.loss_flops``, exp
    counted as one op)."""
    from repro_torch.kernels.distill_loss import loss_flops

    reads = (1 if entry == "ce" else 2) + (1 if direction == "bwd" else 0)
    return itemsize * reads * n * V + 16 * n, loss_flops(direction, entry == "t", n, V)


def time_distill(dev, tag, B, N, V, dtype, entries, cold=False, launches=TIMED_LAUNCHES):
    """Device ms of each (entry, beta) in ``entries`` at (B, N, V), forward
    and backward, through the launch functions with labels already
    validated, beside the plain versions and, for every beta = 0 forward,
    ``F.cross_entropy`` on the same logits. ``cold``: each timed run
    rotates through COLD_COPIES sets of inputs (above the 50 MB L2), and so
    do the plain version and the library call. Returns JSON rows keyed
    (row name, tag, beta)."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref as R
    from repro_torch.kernels.distill_loss import _bwd_cuda, _bwd_variant, _fwd_cuda, _fwd_variant

    n, it = B * N, dtype.itemsize
    copies = [_distill_inputs(B, N, V, dev, seed=c) for c in range(COLD_COPIES if cold else 1)]
    # each operand's copies side by side in one allocation, so that a
    # rotation reads its entry's inputs and nothing else lies between them
    zs, ts, ys = (torch.stack([c[i] for c in copies]) for i in range(3))
    del copies
    zs, ts = zs.to(dtype), ts.to(dtype)
    ins = [(zs[c], ts[c], ys[c], ys[c].to(torch.int32)) for c in range(len(zs))]
    g = torch.ones((B, N), device=dev)

    def rotating(fn):
        k = itertools.count()
        return lambda: fn(*ins[next(k) % len(ins)])

    lib_ms = device_ms(rotating(lambda z, t, y, y32: F.cross_entropy(
        z.view(-1, V), y.view(-1), reduction="none")), launches)
    rows = {}
    for entry, beta in entries:
        sfx = "_ce" if entry == "ce" else ""
        stats = [_fwd_cuda(z, None if entry == "ce" else t, y32, beta, 1.0)[1]
                 for z, t, y, y32 in ins]
        shape = f"({B},{N},{V}) {str(dtype)[6:]} beta={beta}{' cold' if cold else ''}"
        for direction in ("fwd", "bwd"):
            if direction == "fwd":
                kernel = rotating(lambda z, t, y, y32: _fwd_cuda(
                    z, None if entry == "ce" else t, y32, beta, 1.0))
                plain = rotating(lambda z, t, y, y32: R.distill_loss_batched_ref(
                    z, y, t, beta, 1.0) if entry == "t" else R.softmax_xent_ref(z, y))
                variant = _fwd_variant(n, V, dtype)[0]
            else:
                k = itertools.count()

                def kernel():
                    i = next(k) % len(ins)
                    z, t, _, y32 = ins[i]
                    return _bwd_cuda(z, None if entry == "ce" else t, y32, stats[i], g, beta,
                                     1.0)

                plain = rotating(lambda z, t, y, y32: R.distill_loss_grad_ref(
                    z, y, t, beta, 1.0, g=g) if entry == "t" else R.softmax_xent_grad_ref(
                    z, y, 1.0, g=g))
                variant = _bwd_variant(V, dtype)[0]
            ms, eager = device_ms(kernel, launches), eager_ms(kernel, launches)
            plain_ms = device_ms(plain, launches)
            library_ms = lib_ms if direction == "fwd" and beta == 0.0 else None
            b, by = bound_ms(*_distill_bounds(entry, direction, n, V, it))
            name = f"distill_loss_{direction}{sfx}"
            print(f"{name} [{variant}] {tag} {shape}: kernel {ms:.5f} ms device "
                  f"({eager:.5f} ms eager)  plain {plain_ms:.5f} ms  bound {b:.6f} ms ({by}), "
                  f"{b / ms:.2f} of it"
                  + (f"  F.cross_entropy {library_ms:.5f} ms" if library_ms is not None else ""))
            rows[(name, tag, beta)] = dict(shape=shape, variant=variant, ms=ms,
                                           plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                           library_ms=library_ms)
    del ins, zs, ts, ys
    torch.cuda.empty_cache()
    return rows


DISTILL_TIMED = [("ce", 0.0), ("t", 0.0), ("t", 1.5)]


def time_kernels(dev):
    """Times at the main path's shape (FedEEC: 8 rows of 10 classes) and at
    the LM bench shapes. Device times come from CUDA graphs of many calls;
    the eager time per call is printed beside. Each kernel is timed through
    its launch function with labels already validated. The bound counts
    each input read once and each output written once, against 3.35 TB/s,
    and the fp32 operations (exp counted as one) against 67 TFLOP/s.
    distill_loss at (4, 256, 2048) fp32 (16.8 MB of z and t) fits in the
    L2, so it is timed both warm (as in earlier runs) and cold."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.skr_rectify import map_flops

    rows = {}
    rows.update(time_distill(dev, "main", 1, 8, 10, torch.float32, DISTILL_TIMED))
    rows.update(time_distill(dev, "lm", 4, 256, 2048, torch.float32, DISTILL_TIMED))
    rows.update(time_distill(dev, "lm_cold", 4, 256, 2048, torch.float32, DISTILL_TIMED,
                             cold=True))
    # the LM distillation step's student loss: the t entry in fp32 at beta 1.5
    rows.update(time_distill(dev, "lm_distill", *DISTILL_TEACHER_SHAPE, torch.float32,
                             [("t", 1.5)], launches=20))
    for tag, (B, N, C) in [("main", (1, 8, 10)), ("lm", (4, 256, 1024))]:
        probs, labels, qbar, counts = _skr_inputs(B, N, C, dev)
        labels = labels.long()
        p_c = probs.gather(-1, labels[..., None])[..., 0].contiguous()
        do = (probs.argmax(-1) != labels) & (counts.gather(-1, labels) > 0)
        qb = qbar.gather(-1, labels).contiguous()
        y32 = labels.to(torch.int32)
        out = torch.empty_like(probs)

        def launch():
            _lib.launch("skr_rectify", dev, probs.data_ptr(), y32.data_ptr(), p_c.data_ptr(),
                        do.data_ptr(), qb.data_ptr(), out.data_ptr(), B * N, C)

        n = B * N
        rows[("skr_rectify_map", tag, None)] = _timed(
            "skr_rectify [map]", tag, f"({B},{N},{C})", launch,
            lambda: R.skr_rectify_rows_ref(probs, labels, p_c, do, qb), None,
            4 * 2 * n * C + n * (4 + 4 + 1 + 4), map_flops(n, C))
        torch.cuda.synchronize()
        if not torch.equal(out, R.skr_rectify_rows_ref(probs, labels, p_c, do, qb)):
            fail("the timed skr_rectify launches disagree with the plain version")
    rows.update(time_skr_fused(dev))
    return rows


def time_skr_fused(dev):
    """The fused SKR entry (queue pass + map) through its launch function,
    at the main path's teacher step (1, 8, 10, queues of 20), at (4, 256,
    1024, 20) and at the LM distillation step's teacher step (1, 128,
    128256, 20; a graph of 10 launches). Its plain version is a loop of
    about 20 torch ops a row, so at the larger shapes a graph holds one
    call of it, not 200. The
    bound counts probs and int64 labels read, Q written, and the state
    (q, count, head) read and written once; operations, 2·n·C + n·Bq (the
    argmax, the map's products, at most Bq adds a row for the queue mean),
    bind nowhere near."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.skr_rectify import process_flops

    rows = {}
    for tag, (B, N, C, Bq), launches, plain_launches in [
            ("main", (1, 8, 10, 20), TIMED_LAUNCHES, TIMED_LAUNCHES),
            ("lm", (4, 256, 1024, 20), TIMED_LAUNCHES, 1),
            ("lm_distill", SKR_TEACHER_SHAPE, 10, 1)]:
        probs, labels, q, count, head = ins = _skr_state(B, N, C, Bq, dev)
        out, new_q = torch.empty_like(probs), torch.empty_like(q)
        ints = torch.zeros(2 * B * C + B, dtype=torch.int32, device=dev)  # err words zero

        def launch():
            _lib.launch("skr_process", dev, probs.data_ptr(), labels.data_ptr(), 1,
                        q.data_ptr(), count.data_ptr(), head.data_ptr(), out.data_ptr(),
                        new_q.data_ptr(), ints.data_ptr(), ints[B * C:].data_ptr(),
                        ints[2 * B * C:].data_ptr(), B, N, C, Bq, count_as="skr_rectify")

        def plain():
            return R.skr_process_batched_ref(*ins)

        n = B * N
        ms, eager = device_ms(launch, launches), eager_ms(launch, launches)
        plain_ms = device_ms(plain, plain_launches)
        b, by = bound_ms(4 * 2 * n * C + 8 * n + 2 * (4 * B * C * Bq + 8 * B * C) + 4 * B,
                         process_flops(B, N, C, Bq))
        shape = f"({B},{N},{C}) Bq {Bq}"
        print(f"skr_rectify [fused] {tag} {shape}: kernel {ms:.5f} ms device ({eager:.5f} ms "
              f"eager)  plain {plain_ms:.5f} ms  bound {b:.6f} ms ({by}), {b / ms:.3f} of it")
        rows[("skr_rectify", tag, None)] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                                                bound_ms=b, bound_by=by, library_ms=None)
        torch.cuda.synchronize()
        want = plain()
        got = (out, new_q, ints[:B * C].view(B, C), ints[B * C:2 * B * C].view(B, C))
        if not all(torch.equal(a, w) for a, w in zip(got[1:], want[1:])) or \
                (got[0] - want[0]).abs().max().item() > 1e-6 or ints[2 * B * C:].any():
            fail("the timed skr_rectify fused launches disagree with the plain version")
    return rows


def time_skr_queue_pass(dev):
    """SKR per teacher step at FedEEC's shape (8 rows, 10 classes, queues
    of 20), issued eagerly as the main path issues it:
    ``skr_process_batch``, one fused launch and no read-back (its fault
    words are read at the caller's next sync; the line is printed under
    the name the loop of torch ops had before the fused entry,
    'skr_process_batch (8 rows, 10 classes, queue 20)'). Beside it: that
    loop, which is now the plain version, on the card; the fused entry with
    a sync and a read of its fault words after each call (what a read-back
    per launch costs); and the fused launch behind ``_lib.check_labels``
    instead of the fault words. Then the torch ops each dispatches per call
    (the kernel's launch goes through ctypes and is not among them)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.skr import skr_process_batch
    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R

    probs, labels, q, count, head = (t[0] for t in _skr_state(1, 8, 10, 20, dev))
    state = {"q": q, "count": count, "head": head}

    def fused():
        return skr_process_batch(state, probs, labels)

    def plain():
        return R.skr_process_ref(probs, labels, q, count, head)

    def synced():
        out = skr_process_batch(state, probs, labels)
        _lib.raise_faults(dev)
        return out

    def checked():
        y32 = _lib.check_labels("skr_process", labels, 10)
        out, new_q = torch.empty_like(probs), torch.empty_like(q)
        ints = torch.empty(21, dtype=torch.int32, device=dev)
        _lib.launch("skr_process", dev, probs.data_ptr(), y32.data_ptr(), 0, q.data_ptr(),
                    count.data_ptr(), head.data_ptr(), out.data_ptr(), new_q.data_ptr(),
                    ints.data_ptr(), ints[10:].data_ptr(), ints[20:].data_ptr(), 1, 8, 10, 20,
                    count_as="skr_rectify")

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.views += func.is_view
            return func(*args, **(kwargs or {}))

    fns = (("fused", fused), ("plain", plain), ("synced", synced), ("checked", checked))
    ms = {name: eager_ms(fn) for name, fn in fns}
    ops = {}
    for name, fn in fns:
        with Count() as c:
            fn()
        ops[name] = (c.ops, c.ops - c.views)
    torch.cuda.synchronize()
    print(f"skr_process_batch (8 rows, 10 classes, queue 20): {ms['fused']:.4f} ms per call, "
          f"eager (one fused launch; {ops['fused'][1]} non-view torch ops of "
          f"{ops['fused'][0]} dispatched)")
    print(f"  the plain version (the queue-pass loop of torch ops, the map in torch ops): "
          f"{ms['plain']:.4f} ms per call, eager ({ops['plain'][1]} non-view torch ops of "
          f"{ops['plain'][0]})")
    print(f"  the fused entry with a sync and a read of its fault words after each call: "
          f"{ms['synced']:.4f} ms per call, eager")
    print(f"  the fused launch with _lib.check_labels before it instead of the fault words: "
          f"{ms['checked']:.4f} ms per call, eager ({ops['checked'][1]} non-view torch ops "
          f"of {ops['checked'][0]})")


def expected_launches(cfg, rounds, dev):
    """Kernel launches ``rounds`` plain FedEEC rounds make, from the
    trainer's own ``pair_steps``: per student step one forward and one
    backward (two of each for a data-holding leaf: local CE and bridge
    loss); per teacher step one launch of SKR's fused entry (queue pass
    and rectification), and none of the map alone."""
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem

    _, tree, client_data, auto = build_problem(cfg, device=dev)
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device=dev)
    fwd = skr = 0
    for v, p in trainer.round_pairs():
        for s, t in ((v, p), (p, v)):
            k = trainer.pair_steps(s, t)
            fwd += k * (2 if s in client_data else 1)
            skr += k
    return {"distill_loss_fwd": rounds * fwd, "distill_loss_bwd": rounds * fwd,
            "skr_rectify": rounds * skr}


def drive_main_path(dev):
    import math

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import build_problem, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.kernels.skr_rectify import variant_launches as skr_variants

    cfg, rounds = FLConfig(), 3
    print(f"config: {cfg}")
    t0 = time.perf_counter()
    build_problem(cfg, device=dev)  # pretrains the autoencoder (cached)
    torch.cuda.synchronize()
    print(f"build_problem incl. autoencoder pretrain (1200 steps): "
          f"{time.perf_counter() - t0:.3f} s")

    print(f"allocated before the rounds: {torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = run_experiment("fedeec", cfg, rounds=rounds, device=dev)
    counts = {k: ops.launches[k] for k in ("distill_loss_fwd", "distill_loss_bwd",
                                           "skr_rectify")}
    skr_split = dict(skr_variants)
    add_variant_launches()
    torch.cuda.synchronize()
    print(f"round wall s (train, ending in a sync): {res.round_s}")
    print(f"run wall s (rounds + evals): {res.wall_s:.3f}")
    print(f"cloud accuracy curve: {res.acc_curve}")
    print(f"comm bytes: {res.comm_bytes}")
    print(f"peak max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"launches: {counts}")
    want = expected_launches(cfg, rounds, dev)
    print(f"launches predicted from pair_steps: {want}")
    print(f"skr_rectify launches by entry: {skr_split}")
    if len(res.acc_curve) != rounds or not all(
            math.isfinite(a) and 0.0 <= a <= 1.0 for a in res.acc_curve):
        fail(f"bad accuracy curve {res.acc_curve}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
        if n != want[name]:
            fail(f"kernel {name}: {n} launches, pair_steps predicts {want[name]}")
    if skr_split != {"map": 0, "fused": want["skr_rectify"]}:
        fail(f"skr_rectify by entry {skr_split}: one fused launch a teacher step predicted")
    return counts


def check_step_parity(dev):
    """One student step's loss and gradient on the card and on the CPU (the
    port's plain path, which the CPU tests hold to the JAX package), from
    the same parameters and inputs, for each FL model and both losses.
    Loss within 1e-5 relative; gradient within 1e-5 absolute (each device's
    fp32 gradient lies within about 2e-6 of an fp64 one at these sizes)."""
    import numpy as np
    import torch

    from repro_torch.core import bsbodp
    from repro_torch.core.fedeec import node_generator
    from repro_torch.models.registry import get_fl_model
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad

    rng = np.random.default_rng(0)
    x = rng.random((8, 16, 16, 3), dtype=np.float32)
    lx = rng.random((8, 16, 16, 3), dtype=np.float32)
    y, ly = rng.integers(0, 10, 8), rng.integers(0, 10, 8)
    q = rng.random((8, 10)).astype(np.float32) ** 3
    q /= q.sum(-1, keepdims=True)
    for i, name in enumerate(("cnn1", "resnet10", "resnet18")):
        init, apply = get_fl_model(name)
        p = init(node_generator(0, i), 10, 16)
        for leaf in (False, True):
            out = {}
            for d in (dev, torch.device("cpu")):
                t = lambda a: torch.as_tensor(a).to(d)
                if leaf:
                    fn = lambda pp: bsbodp.leaf_loss(apply(pp, t(lx)), t(ly), apply(pp, t(x)),
                                                     t(y), t(q), 1.5, 1.0)
                else:
                    fn = lambda pp: bsbodp.non_leaf_loss(apply(pp, t(x)), t(y), t(q), 1.5)
                loss, g = value_and_grad(fn, tree_map(lambda a: a.to(d), p))
                out[d.type] = (float(loss), [a.cpu() for a in tree_leaves(g)])
            (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
            err = max((a - b).abs().max().item() for a, b in zip(gg, gc))
            print(f"{name} {'leaf' if leaf else 'non-leaf'} step: loss {lg:.7f} (card) "
                  f"{lc:.7f} (CPU)  grad max|diff| {err:.3e}")
            if abs(lg - lc) > 1e-5 * abs(lc) or err > 1e-5:
                fail(f"{name}: the card's student step disagrees with the CPU's")


def check_group_step_parity(dev):
    """One coalesced group's student step (B = 3 stacked students, the
    model through ``torch.func.vmap``, the losses through the kernels'
    (B, N, V) entries) on the card and on the CPU from the same parameters
    and inputs, for each FL model and both losses: each pair's loss within
    1e-5 relative and the stacked gradient within 1e-5 absolute, the bounds
    of ``check_step_parity``, with the models in fp64 and their logits
    entering the fp32 loss. In fp32 the card's grouped convolutions round
    differently from the CPU's by about 3e-6, and a pre-activation that
    close to ReLU's kink takes the other branch on one device, moving the
    gradients below it by up to 1e-3 of their scale: the fp32 step's
    difference is printed beside the fp64 one, and held to nothing."""
    import numpy as np
    import torch

    from repro_torch.core import bsbodp
    from repro_torch.core.fedeec import node_generator
    from repro_torch.models.registry import get_fl_model
    from repro_torch.tree import tree_leaves, tree_map, tree_stack, value_and_grad

    B = 3
    rng = np.random.default_rng(1)
    x = rng.random((B, 8, 16, 16, 3))
    lx = rng.random((B, 8, 16, 16, 3))
    y, ly = rng.integers(0, 10, (B, 8)), rng.integers(0, 10, (B, 8))
    q = rng.random((B, 8, 10)).astype(np.float32) ** 3
    q /= q.sum(-1, keepdims=True)
    for i, name in enumerate(("cnn1", "resnet10", "resnet18")):
        init, apply1 = get_fl_model(name)
        vapply = torch.func.vmap(apply1)
        P32 = tree_stack([init(node_generator(1, B * i + b), 10, 16) for b in range(B)])
        for leaf in (False, True):
            diffs = {}
            for dtype in (torch.float64, torch.float32):
                P = tree_map(lambda a: a.to(dtype), P32)
                apply = lambda p, a: vapply(p, a.to(dtype)).float()
                out = {}
                for d in (dev, torch.device("cpu")):
                    t = lambda a: torch.as_tensor(a).to(d)
                    if leaf:
                        fn = lambda pp: bsbodp.leaf_loss_batched(
                            apply(pp, t(lx)), t(ly), apply(pp, t(x)), t(y), t(q), 1.5, 1.0)
                    else:
                        fn = lambda pp: bsbodp.non_leaf_loss_batched(apply(pp, t(x)), t(y),
                                                                     t(q), 1.5)
                    pp = tree_map(lambda a: a.to(d), P)
                    with torch.no_grad():
                        losses = fn(pp).cpu()
                    _, g = value_and_grad(lambda p: fn(p).sum(), pp)
                    out[d.type] = (losses, [a.cpu() for a in tree_leaves(g)])
                (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
                diffs[dtype] = (float(((lg - lc).abs() / lc.abs()).max()),
                                max((a - b).abs().max().item() for a, b in zip(gg, gc)))
            (rel, err), (rel32, err32) = diffs[torch.float64], diffs[torch.float32]
            print(f"{name} {'leaf' if leaf else 'non-leaf'} group step (B = {B}), fp64 model: "
                  f"losses max rel diff {rel:.3e}, grad max|diff| {err:.3e}; fp32 model "
                  f"(not held): {rel32:.3e}, {err32:.3e}")
            if rel > 1e-5 or err > 1e-5:
                fail(f"{name}: the card's group step disagrees with the CPU's")


def check_round_parity(dev):
    """One FedEEC round (tiny config) on the card and on the CPU from the
    same parameters: comm bytes and the numpy rng state identical, every
    parameter finite. The parameters are reported, not held to a bound:
    AdamW's first step moves an element by about lr·sign(g) whenever |g|
    is well above eps = 1e-8, and elements whose gradient is below the fp32
    noise (about 1e-6 here) take either sign on either device."""
    import numpy as np
    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.core.fedeec import FedEEC
    from repro_torch.core.topology import Tree
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.fl.metrics import accuracy
    from repro_torch.models.autoencoder import init_autoencoder
    from repro_torch.tree import tree_leaves

    cfg = FLConfig(num_clients=2, num_edges=1, samples_per_client=8, test_samples=64,
                   image_size=8, embed_dim=16, distill_steps=1)
    ds = make_dataset(cfg.dataset, num_train=16, num_test=64, image=8, seed=0)
    parts = dirichlet_partition(ds.y_train, 2, cfg.dirichlet_alpha, seed=0)
    cd = {f"client{i}": (ds.x_train[parts[i]], ds.y_train[parts[i]]) for i in range(2)}
    auto = init_autoencoder(torch.Generator().manual_seed(3), image=8, embed_dim=16)
    runs = {}
    for d in (dev, torch.device("cpu")):
        # node i's init is drawn from the same CPU generator on both devices
        tr = FedEEC(cfg, Tree.three_tier(1, 2), cd, auto, seed=0, device=d)
        tr.train_round()
        runs[d.type] = tr
    g, c = runs["cuda"], runs["cpu"]
    leaves = [(a.cpu(), b) for v in g.params
              for a, b in zip(tree_leaves(g.params[v]), tree_leaves(c.params[v]))]
    err = max((a - b).abs().max().item() for a, b in leaves)
    finite = all(bool(torch.isfinite(a).all()) for a, _ in leaves)
    same_skr = all(torch.equal(g.skr[v][k].cpu(), c.skr[v][k])
                   for v in g.skr for k in ("count", "head"))
    accs = [accuracy(t.cloud_apply(), t.cloud_params(), ds.x_test, ds.y_test) for t in (g, c)]
    print(f"one round card vs CPU: params max|diff| {err:.3e}  SKR counts/heads identical "
          f"{same_skr}  cloud accuracy {accs[0]} vs {accs[1]}")
    if not finite or not np.isfinite(accs[0]):
        fail("the card's FedEEC round produced non-finite values")
    if dict(g.comm.bytes) != dict(c.comm.bytes) or \
            g.rng.bit_generator.state != c.rng.bit_generator.state:
        fail("the card's FedEEC round differs from the CPU's in comm bytes or rng draws")


# the gate configuration of benchmarks/tables/scenarios.json (the table's
# generator, benchmarks/fl_tables.py:scenario_signatures): FLConfig with
# these fields, 4 clients, 2 edges, 2 rounds, no eval
SIM_GATE = dict(samples_per_client=16, test_samples=64, image_size=8, embed_dim=16,
                edge_model="cnn2", cloud_model="cnn2")
# the signature with forced serial dispatch (batch_signature -> None) where
# it differs from the table's, written with coalesced dispatch: under
# faults serial dispatch draws transfer outcomes in another item order
# (ROADMAP.md C9, fixed); pinned against the JAX package by
# tests/test_torch_sim_engine.py
SIM_SERIAL_DISPATCH = {"fedeec/lossy_links": "a777706636504be1"}
SIM_FAULT_COUNTERS = ("sim_transfer_failures_total", "sim_transfer_retries_total",
                      "sim_pairs_abandoned_total", "sim_pair_timeouts_total",
                      "sim_departures_total", "sim_regional_outages_total",
                      "sim_link_flaps_total")


def check_sim_signatures(dev, traced=False):
    """Every named scenario at the gate configuration on the card, with
    the trainer's coalesced dispatch: the event signature equal to the
    tracked table's, and the fault counters of lossy_links and
    regional_outage equal to BENCH_faults.json's; then lossy_links once
    more with serial dispatch forced, held to SIM_SERIAL_DISPATCH.
    ``traced`` runs each under a ``Tracer``, which takes the simulator's
    general pricing loop: the same table, and one item span per priced
    item (one ``pair_start`` each)."""
    import torch

    from repro_torch.configs.fedeec_paper import paper_setting
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.scenarios import get_scenario, list_scenarios

    table = json.loads((ROOT / "benchmarks" / "tables" / "scenarios.json").read_text())
    faults = json.loads((ROOT / "BENCH_faults.json").read_text())
    cfg = paper_setting("synth_cifar10", 4, 2, **SIM_GATE)
    t0 = time.perf_counter()
    runs = [(name, False) for name in list_scenarios()]
    runs += [(key[len("fedeec/"):], True) for key in SIM_SERIAL_DISPATCH]
    for name, serial in runs:
        key = f"fedeec/{name}"
        _, tree, client_data, auto = build_problem(cfg, device=dev)
        trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device=dev)
        if serial:
            trainer.batch_signature = lambda item: None
        tracer = Tracer() if traced else None
        engine = SimEngine(trainer, get_scenario(name), seed=cfg.seed, tracer=tracer)
        with tracing(tracer):
            sig = engine.run(2).signature()
        torch.cuda.synchronize()
        if traced:
            n_items = sum(sp.cat == "item" for sp in tracer.spans)
            print(f"{name:<16} traced: {len(tracer.spans)} spans, {n_items} item spans, "
                  f"{engine.log.count('pair_start')} pair_start events")
            if n_items != engine.log.count("pair_start") or n_items == 0:
                fail(f"scenario {name}: {n_items} item spans for "
                     f"{engine.log.count('pair_start')} priced items")
        want = SIM_SERIAL_DISPATCH[key] if serial else table[key]
        snap = engine.metrics.snapshot()
        got = {c: int(snap.get(c, {}).get("value", 0)) for c in SIM_FAULT_COUNTERS}
        note = " (forced serial dispatch, ROADMAP C9)" if serial else ""
        stats = engine.dispatch_stats
        print(f"{name:<16} signature {sig} want {want}{note}  "
              f"events {len(engine.log.entries)}  failed pairs {len(trainer.failed_pairs)}  "
              f"dispatches {stats['dispatches']} of {stats['items']} items, "
              f"{stats['batched_dispatches']} batched")
        if sig != want:
            fail(f"scenario {name}: the card's event signature {sig} != {want}")
        if serial and stats["batched_dispatches"]:
            fail(f"scenario {name}: forced serial dispatch ran {stats}")
        if name in ("lossy_links", "regional_outage") and not serial:
            tracked = {c: faults[name][c] for c in SIM_FAULT_COUNTERS}
            print(f"{'':<16} fault counters {got}")
            if got != tracked:
                fail(f"scenario {name}: fault counters {got} != BENCH_faults.json {tracked}")
    print(f"{len(runs)} {'traced ' * traced}gate runs on the card: "
          f"{time.perf_counter() - t0:.3f} s")


def item_launches(item, client_data) -> dict:
    """The FedEEC kernels' launches of one pair item, or of one coalesced
    group of such items (a group step launches each kernel once): each
    direction's steps take a student step, one distill_loss launch each
    way (two when the student, the child, holds data), and a teacher step,
    one launch of SKR's fused entry."""
    k = item.steps
    fwd = k * (2 if item.node in client_data else 1) + k
    return {"distill_loss_fwd": fwd, "distill_loss_bwd": fwd, "skr_rectify": 2 * k}


def replay_sim_schedule(cfg, scenario, rounds, dev, serial=False):
    """The scenario run's schedule replayed on the CPU with cnn2 at every
    tier (pair steps, bytes, times and the dispatch groups do not depend
    on the models: a signature separates leaf pairs from edge pairs
    whatever the tiers' models are), from the same problem (the
    autoencoder cached on the card): its event log without evals, its
    dispatch stats, and the kernel launches the card's run must make,
    added up per dispatch (``item_launches``, a coalesced group counting
    as one item). ``serial`` forces serial dispatch."""
    from dataclasses import replace

    from repro_torch.core.fedeec import FedEEC
    from repro_torch.fl.engine import build_problem
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.scenarios import get_scenario

    small = replace(cfg, end_model="cnn2", edge_model="cnn2", cloud_model="cnn2")
    _, tree, cd, auto = build_problem(small, device=dev)
    trainer = FedEEC(small, tree, cd, auto, seed=small.seed, device="cpu")
    if serial:
        trainer.batch_signature = lambda item: None
    want = dict.fromkeys(("distill_loss_fwd", "distill_loss_bwd", "skr_rectify"), 0)
    execute, execute_batch = trainer.execute, trainer.execute_batch

    def count(item):
        for name, n in item_launches(item, cd).items():
            want[name] += n

    def counted(item):
        count(item)
        execute(item)

    def counted_batch(items):
        if len(items) == 1:  # execute_batch hands a lone item to execute
            return counted(items[0])
        count(items[0])  # one launch of each a group step, whatever its size
        execute_batch(items)

    trainer.execute, trainer.execute_batch = counted, counted_batch
    engine = SimEngine(trainer, get_scenario(scenario), seed=small.seed)
    t0 = time.perf_counter()
    engine.run(rounds)
    print(f"CPU replay (cnn2 at every tier, no eval): {time.perf_counter() - t0:.3f} s, "
          f"{len(engine.log.entries)} events, dispatch stats {engine.dispatch_stats}")
    return _without_evals(engine.log.entries), want, engine.dispatch_stats


def _without_evals(entries):
    return [{k: v for k, v in e.items() if k != "ord"} for e in entries if e["kind"] != "eval"]


def drive_sim_path(dev):
    """``run_experiment("fedeec", FLConfig(), rounds=3,
    scenario="mobile_clients")`` on the card, full width, with coalesced
    dispatch and the launch counters zeroed just before and read just
    after, held to the CPU replay's prediction; the card's log without its
    evals and its dispatch stats equal to the replay's. Returns the
    launches and the run's result."""
    import math

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import build_problem, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.kernels.skr_rectify import variant_launches as skr_variants

    cfg, rounds, scenario = FLConfig(), 3, "mobile_clients"
    build_problem(cfg, device=dev)  # the autoencoder, cached since the main path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = run_experiment("fedeec", cfg, rounds=rounds, scenario=scenario, device=dev)
    counts = {k: ops.launches[k] for k in ("distill_loss_fwd", "distill_loss_bwd",
                                           "skr_rectify")}
    skr_split = dict(skr_variants)
    add_variant_launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    host = sum(res.round_s)
    print(f"round host s (churn + items, ending in a sync): {res.round_s}")
    print(f"run wall s (rounds + evals): {res.wall_s:.3f}  rounds' share "
          f"{host / res.wall_s:.3f}")
    print(f"simulated s: {res.sim_wall_s}  sim curve: {res.sim_curve}")
    print(f"event counts: {res.event_counts}")
    print(f"event signature: {res.event_signature}")
    print(f"dispatch stats: {res.dispatch_stats}")
    print(f"comm bytes: {res.comm_bytes}")
    print(f"cloud accuracy curve: {res.acc_curve}")
    print(f"peak max_memory_allocated: {peak:.1f} MiB")
    print(f"launches: {counts}")
    log, want, stats = replay_sim_schedule(cfg, scenario, rounds, dev)
    print(f"launches predicted by the CPU replay: {want}")
    print(f"skr_rectify launches by entry: {skr_split}")
    if len(res.acc_curve) != rounds or not all(
            math.isfinite(a) and 0.0 <= a <= 1.0 for a in res.acc_curve):
        fail(f"bad accuracy curve {res.acc_curve}")
    if res.event_counts.get("migrate", 0) == 0:
        fail("mobile_clients migrated no client: the run did not exercise migration")
    if res.dispatch_stats != stats or stats["batched_dispatches"] <= 0:
        fail(f"dispatch stats {res.dispatch_stats}: the CPU replay's {stats}, with "
             f"coalesced groups, expected")
    if _without_evals(res.event_log) != log:
        fail("the card's event log (without evals) differs from the CPU replay's")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the scenario path")
        if n != want[name]:
            fail(f"kernel {name}: {n} launches on the scenario path, the replay "
                 f"predicts {want[name]}")
    if skr_split != {"map": 0, "fused": want["skr_rectify"]}:
        fail(f"skr_rectify by entry {skr_split} on the scenario path: one fused launch a "
             f"teacher step predicted")
    return counts, res


# every op of kernels/ops.py, by its kernel_dispatch_seconds label
KERNEL_LABELS = ("softmax_xent", "softmax_xent_batched", "distill_loss",
                 "distill_loss_batched", "skr_rectify", "skr_rectify_batched",
                 "skr_process", "skr_process_batched", "flash_attention", "latent_decode",
                 "rwkv6_scan")
FORWARD_LABELS = KERNEL_LABELS[:4]  # one distill_loss forward launch a call
TRACED_CATEGORIES = {"churn", "dispatch", "execute", "item", "round", "eval", "kernel"}


def _dispatch_counts() -> dict:
    from repro_torch.obs.metrics import global_registry

    reg = global_registry()
    return {k: reg.histogram("kernel_dispatch_seconds", kernel=k).count
            for k in KERNEL_LABELS}


def drive_traced_sim_path(dev, untraced):
    """``run_experiment("fedeec", FLConfig(), rounds=3,
    scenario="mobile_clients", tracer=Tracer())`` on the card, held to the
    untraced run ``untraced`` of ``drive_sim_path``: the same schedule; the
    Chrome trace written and read back through the report CLI; the span
    categories; per op label, the kernel spans equal to the observations of
    ``kernel_dispatch_seconds``; the forward ops' spans equal to
    distill_loss's forward launches (both entries) and the ``skr_process*``
    spans to the fused entry's; each round span's host seconds within 2% or
    5 ms of ``round_s``. The launches here are not added to the kernels
    line's counts (``add_variant_launches`` is not called), so its launch
    column stays the untraced main paths'."""
    import contextlib
    import io
    import tempfile
    from collections import Counter

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import run_experiment
    from repro_torch.kernels import ops
    from repro_torch.kernels.distill_loss import variant_launches as distill_variants
    from repro_torch.kernels.skr_rectify import variant_launches as skr_variants
    from repro_torch.obs import report
    from repro_torch.obs.trace import Tracer

    cfg, rounds, scenario = FLConfig(), 3, "mobile_clients"
    before = _dispatch_counts()
    ops.reset_launches()
    tracer = Tracer()
    res = run_experiment("fedeec", cfg, rounds=rounds, scenario=scenario, tracer=tracer,
                         device=dev)
    torch.cuda.synchronize()
    fwd = sum(n for k, n in distill_variants.items() if k.split(":")[0] in ("fwd", "fwd_ce"))
    fused, skr_map = skr_variants["fused"], skr_variants["map"]
    observed = {k: n - before[k] for k, n in _dispatch_counts().items()}
    spans = Counter(sp.name[len("kernel."):] for sp in tracer.spans if sp.cat == "kernel")
    cats = Counter(sp.cat for sp in tracer.spans)
    round_spans = sorted((sp for sp in tracer.spans if sp.cat == "round"),
                         key=lambda sp: sp.args["round"])
    span_s = [sp.host_dur for sp in round_spans]
    print(f"traced round host s (churn + items, ending in a sync): {res.round_s}")
    print(f"untraced round host s (drive_sim_path):               {untraced.round_s}")
    print(f"round span host s:                                    {span_s}")
    print(f"run wall s traced {res.wall_s:.3f}, untraced {untraced.wall_s:.3f}")
    print(f"spans by category: {dict(sorted(cats.items()))}  instants {len(tracer.instants)}")
    print(f"kernel spans by op: {dict(sorted(spans.items()))}")
    print(f"kernel_dispatch_seconds observations by op: "
          f"{ {k: n for k, n in observed.items() if n} }")
    print(f"distill_loss forward launches (both entries): {fwd}  by entry and variant: "
          f"{dict(distill_variants)}")
    print(f"skr_rectify launches by entry: {dict(skr_variants)}")
    print(f"event signature traced {res.event_signature}, untraced {untraced.event_signature}"
          f" ({'equal' if res.event_signature == untraced.event_signature else 'differ'}); "
          f"cloud accuracy curve traced {res.acc_curve}, untraced {untraced.acc_curve}")
    # the schedule holds bit for bit; the evals' accuracies may differ
    # between two runs on the card (cuDNN's backward, ROADMAP C5), and then
    # so does the signature, which hashes them
    if _without_evals(res.event_log) != _without_evals(untraced.event_log) or \
            res.sim_times != untraced.sim_times:
        fail("the traced run's event log (without evals) or eval times differ from the "
             "untraced run's")
    if res.dispatch_stats != untraced.dispatch_stats:
        fail(f"dispatch stats traced {res.dispatch_stats} != untraced "
             f"{untraced.dispatch_stats}")
    if set(cats) != TRACED_CATEGORIES:
        fail(f"span categories {sorted(cats)} != {sorted(TRACED_CATEGORIES)}")
    if cats["item"] != res.event_counts.get("pair_start", 0):
        fail(f"{cats['item']} item spans for {res.event_counts.get('pair_start')} items")
    if any(spans[k] != observed[k] for k in KERNEL_LABELS) or set(spans) - set(KERNEL_LABELS):
        fail(f"kernel spans {dict(spans)} != kernel_dispatch_seconds counts {observed}")
    if sum(spans[k] for k in FORWARD_LABELS) != fwd or fwd <= 0:
        fail(f"forward op spans {sum(spans[k] for k in FORWARD_LABELS)} != distill_loss "
             f"forward launches {fwd}")
    if spans["skr_process"] + spans["skr_process_batched"] != fused or fused <= 0 or skr_map:
        fail(f"skr_process spans != skr_rectify fused launches {dict(skr_variants)}")
    if [sp.args["round"] for sp in round_spans] != list(range(rounds)):
        fail(f"round spans {[sp.name for sp in round_spans]}")
    for r, (a, b) in enumerate(zip(span_s, res.round_s)):
        if abs(a - b) > max(0.02 * b, 0.005):
            fail(f"round {r}: span host s {a} vs round_s {b}, beyond 2% or 5 ms")
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "trace.json")
        tracer.to_json(path)
        doc = json.loads(Path(path).read_text())
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = report.main([path, "--json"])
    file_cats = {e["cat"] for e in doc["traceEvents"] if e["ph"] == "X"}
    rep = json.loads(out.getvalue()) if rc == 0 else []
    print(f"trace file: {len(doc['traceEvents'])} events, categories {sorted(file_cats)}; "
          f"report --json: rc {rc}, " + ", ".join(
              f"round {r['round']} gated by {r['gate_node']} ({r['gate_factor']}, "
              f"{r['makespan_s']} sim-s)" for r in rep))
    if rc != 0 or [r["round"] for r in rep] != list(range(rounds)):
        fail(f"the report CLI read the trace back with rc {rc}: {rep}")
    if file_cats != TRACED_CATEGORIES:
        fail(f"trace file categories {sorted(file_cats)}")


def drive_traced_plain_round(dev):
    """``run_experiment("fedeec", FLConfig(), rounds=1, tracer=Tracer())``
    on the plain path: one ``execute`` span per work item of the round,
    the trainer's own items, in its order."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem, run_experiment
    from repro_torch.obs.trace import Tracer

    cfg = FLConfig()
    _, tree, client_data, auto = build_problem(cfg, device=dev)
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device=dev)
    items = [(it.kind, it.node, it.peer) for it in trainer.work_items(0, trainer.participates)]
    del trainer
    tracer = Tracer()
    res = run_experiment("fedeec", cfg, rounds=1, tracer=tracer, device=dev)
    execs = [(sp.name, sp.node, sp.args["peer"]) for sp in tracer.spans
             if sp.cat == "execute"]
    cats = sorted({sp.cat for sp in tracer.spans})
    print(f"plain round: {len(execs)} execute spans for {len(items)} work items, "
          f"span categories {cats}, round host s {res.round_s}")
    if execs != [(f"execute {k} {n}", n, p) for k, n, p in items] or not items:
        fail("the plain round's execute spans are not one per work item")
    if cats != ["execute", "kernel"]:
        fail(f"plain round span categories {cats}")


def check_bench_obs(dev):
    """``BENCH_obs.json``'s contract, read as data, at its configuration
    (``benchmarks/obs_bench.py``: straggler_heavy, 4 clients, 2 edges,
    cnn2, 1 round): the simulator's metric names, the span categories plus
    ``kernel`` (the port's FedEEC runs through the kernel ops; the
    reference's computes in jnp), round 0's gate, and, after one eval,
    both global metric names."""
    import numpy as np

    from repro_torch.configs.fedeec_paper import paper_setting
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.fl.metrics import accuracy
    from repro_torch.obs.critical_path import rounds_from_eventlog
    from repro_torch.obs.metrics import global_registry
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.scenarios import get_scenario

    bench = json.loads((ROOT / "BENCH_obs.json").read_text())
    cfg = paper_setting("synth_cifar10", 4, 2, **SIM_GATE)
    ds, tree, client_data, auto = build_problem(cfg, device=dev)
    trainer = create_algorithm("fedeec", cfg, tree, client_data, auto, device=dev)
    tracer = Tracer()
    engine = SimEngine(trainer, get_scenario("straggler_heavy"), seed=cfg.seed, tracer=tracer)
    with tracing(tracer):
        engine.run(1)
    accuracy(trainer.cloud_apply(), trainer.cloud_params(), ds.x_test, ds.y_test)
    names = engine.metrics.names()
    cats = sorted({sp.cat for sp in tracer.spans if sp.cat})
    rep = rounds_from_eventlog(engine.log.entries)[0]
    gate = {"node": rep.gate_node, "factor": rep.gate_factor}
    print(f"BENCH_obs: {len(names)} sim metric names, categories {cats}, round 0 gate {gate}")
    if names != bench["sim_metric_names"]:
        fail(f"sim metric names {names} != BENCH_obs.json's")
    if cats != sorted(bench["span_categories"] + ["kernel"]):
        fail(f"span categories {cats} != BENCH_obs.json's plus kernel")
    if gate != bench["round0_gate"]:
        fail(f"round 0 gate {gate} != BENCH_obs.json's {bench['round0_gate']}")
    missing = set(bench["global_metric_names"]) - set(global_registry().names())
    if missing:
        fail(f"global metric names missing after one eval: {sorted(missing)}")


def run_tracing_phase(dev, untraced):
    check_sim_signatures(dev, traced=True)
    drive_traced_sim_path(dev, untraced)
    drive_traced_plain_round(dev)
    check_bench_obs(dev)


# the baselines' main path at FLConfig(): (algorithm, rounds)
BASELINE_RUNS = (("hierfavg", 3), ("hiermo", 1), ("hierqsgd", 1), ("demlearn", 1),
                 ("fedavg", 1))


def expected_baseline_launches(name, cfg, rounds, dev):
    """The CE entry's launches ``rounds`` plain rounds of baseline ``name``
    make, from the trainer's own work items: one forward and one backward
    per local step, ``steps`` (local_steps x kappa1) of them per client, and
    every client participates on the plain path."""
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem

    _, tree, client_data, auto = build_problem(cfg, device=dev)
    trainer = create_algorithm(name, cfg, tree, client_data, auto, device=dev)
    return rounds * sum(it.steps for it in trainer.work_items(0, trainer.participates)
                        if it.kind == "local")


def drive_baselines_path(dev):
    """``run_experiment(name, FLConfig(), rounds=...)`` on the card for each
    of BASELINE_RUNS (cnn1 on every node, 20 clients, 5 edges, batch 8),
    with the launch counters zeroed just before each run and read just
    after: every local step launches distill_loss's CE entry once forward
    (``regs``) and once backward (``rows``) and no other kernel, as many as
    the work items predict, and the CE entry's plain versions
    (``ref.softmax_xent_ref`` / ``softmax_xent_grad_ref``) never run."""
    import math

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import build_problem, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.distill_loss import variant_launches

    cfg = FLConfig()
    build_problem(cfg, device=dev)  # the autoencoder, cached since the main path
    plain_calls = {"softmax_xent_ref": 0, "softmax_xent_grad_ref": 0}
    real = {k: getattr(R, k) for k in plain_calls}

    def counted(k):
        def fn(*a, **kw):
            plain_calls[k] += 1
            return real[k](*a, **kw)
        return fn

    totals = {"distill_loss_fwd": 0, "distill_loss_bwd": 0}
    for name, rounds in BASELINE_RUNS:
        want = expected_baseline_launches(name, cfg, rounds, dev)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        plain_calls.update(dict.fromkeys(plain_calls, 0))
        for k in plain_calls:
            setattr(R, k, counted(k))
        ops.reset_launches()
        try:
            res = run_experiment(name, cfg, rounds=rounds, device=dev)
        finally:
            for k, fn in real.items():
                setattr(R, k, fn)
        counts = dict(ops.launches)
        split = {k: n for k, n in variant_launches.items() if n}
        add_variant_launches()
        torch.cuda.synchronize()
        print(f"{name}, {rounds} round(s): round host s (ending in a sync) {res.round_s}; "
              f"run wall s {res.wall_s:.3f}")
        print(f"  cloud accuracy curve {res.acc_curve}; comm bytes {res.comm_bytes}; peak "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"({before:.1f} MiB allocated before the run)")
        print(f"  distill_loss CE entry launches by variant {split}; predicted "
              f"{{'fwd_ce:regs': {want}, 'bwd_ce:rows': {want}}} (clients x rounds x "
              f"local_steps x kappa1); plain version calls {plain_calls}")
        if len(res.acc_curve) != rounds or not all(
                math.isfinite(a) and 0.0 <= a <= 1.0 for a in res.acc_curve):
            fail(f"{name}: bad accuracy curve {res.acc_curve}")
        if split != {"fwd_ce:regs": want, "bwd_ce:rows": want} or want <= 0:
            fail(f"{name}: distill_loss launches {split}, predicted {want} CE launches each way")
        if any(n for k, n in counts.items() if k not in totals):
            fail(f"{name}: launched another kernel: {counts}")
        if any(plain_calls.values()):
            fail(f"{name}: the CE entry's plain version ran on the card: {plain_calls}")
        for k in totals:
            totals[k] += counts[k]
    return totals


def check_baseline_step_parity(dev):
    """One baseline local step's loss and gradient (``fl.baselines.
    local_loss``: cnn1, the CE entry, at a client's batch of 8) on the card
    and on the CPU from the same parameters and batch, within
    ``check_step_parity``'s bounds: loss 1e-5 relative, gradient 1e-5
    absolute."""
    import numpy as np
    import torch

    from repro_torch.fl.baselines import local_loss
    from repro_torch.models.registry import get_fl_model
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad

    rng = np.random.default_rng(4)
    x = rng.random((8, 16, 16, 3), dtype=np.float32)
    y = rng.integers(0, 10, 8)
    init, apply = get_fl_model("cnn1")
    p = init(torch.Generator().manual_seed(0), 10, 16)
    out = {}
    for d in (dev, torch.device("cpu")):
        xb, yb = torch.as_tensor(x).to(d), torch.as_tensor(y).to(d)
        loss, g = value_and_grad(lambda q: local_loss(apply, q, xb, yb),
                                 tree_map(lambda a: a.to(d), p))
        out[d.type] = (float(loss), [a.cpu() for a in tree_leaves(g)])
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    err = max((a - b).abs().max().item() for a, b in zip(gg, gc))
    print(f"cnn1 baseline local step: loss {lg:.7f} (card) {lc:.7f} (CPU)  "
          f"grad max|diff| {err:.3e}")
    if abs(lg - lc) > 1e-5 * abs(lc) or err > 1e-5:
        fail("the card's baseline local step disagrees with the CPU's")


def check_hierfavg_signatures(dev):
    """Every named scenario with ``hierfavg`` at the gate configuration on
    the card (serial dispatch, as the reference's baselines): the event
    signature equal to the tracked table's."""
    import torch

    from repro_torch.configs.fedeec_paper import paper_setting
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.scenarios import get_scenario, list_scenarios

    table = json.loads((ROOT / "benchmarks" / "tables" / "scenarios.json").read_text())
    cfg = paper_setting("synth_cifar10", 4, 2, **SIM_GATE)
    t0 = time.perf_counter()
    for name in list_scenarios():
        _, tree, client_data, auto = build_problem(cfg, device=dev)
        trainer = create_algorithm("hierfavg", cfg, tree, client_data, auto, device=dev)
        engine = SimEngine(trainer, get_scenario(name), seed=cfg.seed)
        sig = engine.run(2).signature()
        torch.cuda.synchronize()
        want = table[f"hierfavg/{name}"]
        print(f"hierfavg/{name:<16} signature {sig} want {want}  "
              f"events {len(engine.log.entries)}")
        if sig != want:
            fail(f"hierfavg/{name}: the card's event signature {sig} != {want}")
    print(f"{len(list_scenarios())} hierfavg gate runs on the card: "
          f"{time.perf_counter() - t0:.3f} s")


# (algorithm, scenario) resumed on the card, at the reference test's small
# config (tests/test_faults.py), 4 rounds, an eval every 2
RESUME_RUNS = (("fedeec", "lossy_links"), ("hierfavg", "regional_outage"))
RESUME_CFG = dict(num_clients=4, num_edges=2, samples_per_client=16, test_samples=64,
                  image_size=8, embed_dim=16, edge_model="cnn2", cloud_model="cnn2")


def check_resume(dev):
    """Each of RESUME_RUNS on the card uninterrupted, then stopped after 2
    rounds with a snapshot (into the gitignored ``checkpoints/``), then
    resumed: the event log without evals and the eval times must equal the
    uninterrupted run's. Accuracies are printed, not held bit for bit:
    card runs are not bitwise repeatable (ROADMAP C5)."""
    import shutil

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.engine import run_experiment

    for algorithm, scenario in RESUME_RUNS:
        cfg = FLConfig(scenario=scenario, **RESUME_CFG)
        ckpt = ROOT / "checkpoints" / f"chip_smoke_{algorithm}_{scenario}"
        shutil.rmtree(ckpt, ignore_errors=True)
        try:
            full = run_experiment(algorithm, cfg, rounds=4, eval_every=2, device=dev)
            run_experiment(algorithm, cfg, rounds=4, eval_every=2, stop_after=2,
                           checkpoint_every=2, checkpoint_dir=str(ckpt), device=dev)
            files = sorted(p.name for p in ckpt.iterdir())
            resumed = run_experiment(algorithm, cfg, rounds=4, eval_every=2,
                                     resume_from=str(ckpt), device=dev)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        same_log = _without_evals(resumed.event_log) == _without_evals(full.event_log)
        print(f"{algorithm}/{scenario}: snapshot {files}; uninterrupted signature "
              f"{full.event_signature}, resumed {resumed.event_signature}; event log "
              f"without evals equal {same_log}; eval times {resumed.sim_times} vs "
              f"{full.sim_times}; accuracy {resumed.acc_curve} vs {full.acc_curve} "
              f"(not held: C5); dispatch stats {full.dispatch_stats}")
        if files != ["engine.json", "trainer.msgpack"]:
            fail(f"{algorithm}/{scenario}: snapshot holds {files}")
        if not same_log or resumed.sim_times != full.sim_times:
            fail(f"{algorithm}/{scenario}: the resumed run's schedule differs from the "
                 f"uninterrupted run's")


def check_lm_checkpoint(dev):
    """``train_lm(checkpoint=)`` on the card: llama3.2-3b reduced
    (``configs.reduced``) to two layers in bf16, 2 steps, the file in the
    gitignored ``checkpoints/``; read back with the port's
    ``load_pytree``, every leaf must equal the in-memory params and AdamW
    state (the trees ``train_lm`` hands to ``convert.lm_to_jax`` /
    ``lm_adamw_to_jax``, still on the card) bit for bit, bf16 included."""
    from dataclasses import replace

    import torch

    from repro_torch import convert
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.train import train_lm

    cfg = replace(reduced(get_arch("llama3.2-3b")), n_repeats=2, num_layers=2,
                  param_dtype="bfloat16", compute_dtype="bfloat16")
    seen = {}
    real = {k: getattr(convert, k) for k in ("lm_to_jax", "lm_adamw_to_jax")}

    def keep(k):
        def fn(tree):
            seen.setdefault(k, tree)  # lm_adamw_to_jax calls lm_to_jax on the moments
            return real[k](tree)
        return fn

    path = ROOT / "checkpoints" / "chip_smoke_lm.msgpack"
    for k in real:
        setattr(convert, k, keep(k))
    try:
        train_lm(cfg, steps=2, batch=2, seq=64, checkpoint=str(path), device=dev)
    finally:
        for k, fn in real.items():
            setattr(convert, k, fn)
    size = path.stat().st_size
    back = load_pytree(str(path))
    path.unlink()

    def leaves(t):  # both trees in one order: the loaded one's keys are sorted
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t]

    def bits(t):
        t = torch.as_tensor(t).detach().cpu().contiguous()
        return str(t.dtype), tuple(t.shape), (
            t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()

    state = seen["lm_adamw_to_jax"]
    pairs = [("params", seen["lm_to_jax"], back["params"]),
             ("m", state["m"], back["opt"]["m"]), ("v", state["v"], back["opt"]["v"]),
             ("step", state["step"], back["opt"]["step"])]
    n = bf16 = 0
    for what, want, got in pairs:
        for a, b in zip(leaves(want), leaves(got), strict=True):
            n += 1
            bf16 += a.dtype == torch.bfloat16
            if a.device.type != "cuda" or bits(a) != bits(b):
                fail(f"LM checkpoint: a leaf of {what} differs from the card's tensor")
    print(f"LM checkpoint of {cfg.name} reduced, 2 layers, bf16: {size} bytes, {n} leaves "
          f"({bf16} bf16) read back bit for bit equal to the card's params and AdamW state")
    if bf16 == 0:
        fail("LM checkpoint: no bf16 leaf was checked")


# serial against coalesced dispatch at FLConfig(): (scenario, timed rounds)
DISPATCH_COMPARE = (("mobile_clients", 2), ("flash_crowd", 2))
DISPATCH_KERNELS = ("distill_loss_fwd", "distill_loss_bwd", "skr_rectify")


def compare_dispatch(dev):
    """Serial against coalesced dispatch at ``FLConfig()`` on the card, for
    each scenario of DISPATCH_COMPARE: two trainers in one process, one
    with serial dispatch forced on the instance (``batch_signature`` ->
    None), each driven through ``SimEngine`` with no eval, a round at a
    time in the order serial, batched, then batched, serial: every round's
    host s (churn and items, ending in a sync), the port's launches by name
    and the dispatch stats. The two runs' event signatures must be equal
    (no faults: the schedule does not depend on the dispatch), and the
    serial run's launches must exceed the batched run's by what its groups
    predict: (size - 1) x a member's launches, for each group. Returns the
    engines, for ``profile_dispatch``."""
    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.api import create_algorithm
    from repro_torch.fl.engine import build_problem
    from repro_torch.kernels import ops
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.scenarios import get_scenario

    cfg = FLConfig()
    held = []
    for scenario, rounds in DISPATCH_COMPARE:
        engines, launches, saved = {}, {}, dict.fromkeys(DISPATCH_KERNELS, 0)
        for mode in ("serial", "batched"):
            _, tree, cd, auto = build_problem(cfg, device=dev)
            trainer = create_algorithm("fedeec", cfg, tree, cd, auto, device=dev)
            if mode == "serial":
                trainer.batch_signature = lambda item: None
            else:
                execute_batch = trainer.execute_batch

                def counted_batch(items, cd=cd, execute_batch=execute_batch, saved=saved):
                    for name, n in item_launches(items[0], cd).items():
                        saved[name] += (len(items) - 1) * n
                    execute_batch(items)

                trainer.execute_batch = counted_batch
            engines[mode] = SimEngine(trainer, get_scenario(scenario), seed=cfg.seed)
            launches[mode] = dict.fromkeys(DISPATCH_KERNELS, 0)
        for r in range(rounds):
            for mode in ("serial", "batched") if r % 2 == 0 else ("batched", "serial"):
                torch.cuda.synchronize()
                ops.reset_launches()
                engines[mode].run(r + 1, sync=torch.cuda.synchronize)
                for k in DISPATCH_KERNELS:
                    launches[mode][k] += ops.launches[k]
        for mode, engine in engines.items():
            print(f"{scenario} {mode:<7}: round host s {engine.round_s}  launches "
                  f"{launches[mode]}  dispatch stats {engine.dispatch_stats}")
        if engines["serial"].log.signature() != engines["batched"].log.signature():
            fail(f"{scenario}: the serial and batched runs' event signatures differ")
        if not any(saved.values()) or any(
                launches["serial"][k] - launches["batched"][k] != saved[k]
                for k in DISPATCH_KERNELS):
            fail(f"{scenario}: serial launches {launches['serial']} - batched "
                 f"{launches['batched']} != the groups' {saved}")
        host = {m: sum(e.round_s) for m, e in engines.items()}
        print(f"{scenario}: round host s over {rounds} rounds, serial {host['serial']:.4f}, "
              f"batched {host['batched']:.4f} (batched / serial "
              f"{host['batched'] / host['serial']:.4f}); launches saved by the groups: {saved}")
        held.append((scenario, rounds, engines))
    return held


def profile_dispatch(held):
    """The next round of each ``compare_dispatch`` run under
    ``torch.profiler``, serial then batched: the kernels launched in the
    round, the device's busy s and idle share, and the port's launches.
    The window is ``profile_kernels``' (a marker lead-in; if every marker
    is lost, the round after runs in a window with twice the lead-in),
    device activity alone: a round's host ops number in the millions, and
    reading them back took minutes. Run last."""
    import torch

    from repro_torch.fl.profile_round import busy_us
    from repro_torch.kernels import ops

    for scenario, rounds, engines in held:
        for mode, engine in engines.items():
            ran = {}

            def body(engine=engine, ran=ran):
                ops.reset_launches()
                ran["round"] = len(engine.round_s) + 1
                t0 = time.perf_counter()
                engine.run(ran["round"], sync=torch.cuda.synchronize)
                ran["wall"] = time.perf_counter() - t0

            t1 = time.perf_counter()
            kernels, lead, lost = profile_kernels(torch.cuda.current_device(), body,
                                                  host_ops=False)
            if not kernels:
                fail("the profiler recorded no device activity")
            busy = busy_us([(t0, t1) for _, t0, t1 in kernels]) / 1e9
            wall = ran["wall"]
            print(f"{scenario} {mode:<7} round {ran['round']} under the profiler: "
                  f"{len(kernels)} kernels, device busy {busy:.4f} s of {wall:.4f} s "
                  f"(idle share {1 - busy / wall:.4f}), port launches "
                  f"{ {k: ops.launches[k] for k in DISPATCH_KERNELS} }, "
                  f"dispatch stats {engine.dispatch_stats}; {lost} of a lead-in of {lead} "
                  f"markers lost; window and trace {time.perf_counter() - t1:.1f} s")


def sdpa_backend(fn) -> str:
    """Which backend of F.scaled_dot_product_attention ran ``fn``, from the
    names of the kernels one call launches under ``torch.profiler`` (in a
    window of ``profile_kernels``): flash, efficient (memory-efficient,
    ``fmha``), cudnn, or math (products and a softmax)."""
    import torch

    fn()
    torch.cuda.synchronize()
    kernels, _, _ = profile_kernels(torch.cuda.current_device(), fn)
    names = sorted(n for n, _, _ in kernels if "elementwise" not in n and "Memset" not in n)
    low = " ".join(names).lower()
    # cuDNN's own kernels carry "flash" in their names too, so test it first
    kind = ("cudnn" if "cudnn" in low else "flash" if "flash" in low
            else "efficient" if "fmha" in low else "math")
    return f"{kind} ({'; '.join(n[:70] for n in dict.fromkeys(names))})"


def time_lm_kernels(dev):
    """Times at the LM serving path's shapes: flash_attention in bf16 at the
    4096-token prefill and at a decode step of 8 requests with the queries
    at position 63 (the middle of the serve run's 128 positions) and 4095
    (a full cache); zamba2-7b's shared attention block (32 heads of 112,
    MHA) the same, and its prefill in fp32 on the 3xTF32 kernel;
    gemma3-12b's global and local layers (head_dim 256, the
    tensor-core kernel's TMA instance) at a 4096-token prompt, and at a
    decode step of 8 requests (the split-KV kernel: the global layer at
    positions 63 and 4095, the local layer's 1024-key window at 4095); the
    3xTF32
    kernel in fp32 at the llama3.2-3b prefill shape, the calls it serves,
    and at the reduced configs' (``configs.reduced``: their q and kv heads
    at head_dim 32, fp32) for 8 and 128 sequences of their max_seq_len;
    rwkv6_scan at a 1024-token prefill (the chunked scan) and a decode step
    (the sequential kernel); whisper-small's attention (head_dim 64, MHA) at
    its 4096-token prefill step (the tensor-core kernel's (64, 64) instance:
    the encoder's 1500 frames and the cross attention over them,
    non-causal, and the decoder's causal self-attention) and at a decode
    step of 8 requests (self-attention at positions 63 and 4095, cross
    attention over the 1500 frames, non-causal). At 1500 frames the work is
    a few microseconds at the bound, so launch latency may set the time.
    The bound counts q, o and the k/v rows the masks leave (each read or
    written once) against 3.35 TB/s, and 4 H flops per unmasked (q, k) pair
    and q head (pairs counted with the window, ``attention_flops``, as the
    kernel's meta entry declares them) against the bf16
    tensor-core peak (989 TFLOP/s: the card could run this bf16 attention
    there) or, in fp32, 3 x 4 H flops against the TF32 tensor-core peak
    (495 TFLOP/s: fp32-accurate products on the tensor cores take three
    TF32 products, as the 3xTF32 kernel runs them; plain TF32 misses the
    fp32 bound), with the bound of 4 H flops at the fp32 cores' 67 TFLOP/s
    printed beside it; for the
    scan, r, k, v, w, u, s0 read and y, sT written once, and 5 hd^2 + 5 hd
    flops per token and head (an FMA as two: y's FMA and the state's
    multiply and FMA per element of S, and the O(hd) bonus term) against
    the fp32 peak (67 TFLOP/s: its inputs and state are fp32). The library
    call for attention is F.scaled_dot_product_attention on the same
    tensors (is_causal at prefill, an explicit boolean mask for a window;
    unmasked over the cache rows the query sees at decode: up to pos, and
    from pos - window + 1 with a window), its backend
    named from the profiler; the scan has none. The wrapper runs the
    tensor-core kernel at bf16 prefill and the split-KV kernel at decode; at
    each of those shapes the 3xTF32 attention kernel, which it does not pick
    there, is launched directly, timed beside them and held to the same
    bound; so is the sequential rwkv6_scan kernel at the prefill shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import attention_flops

    rows = {}
    bf16 = torch.bfloat16
    small = reduced(get_arch("llama3.2-3b"))
    red = (small.max_seq_len, small.max_seq_len, small.num_heads, small.num_kv_heads,
           small.head_dim)
    for name, tag, (B, Sq, Sk, N, K, H, *hv), qo, window, dtype, *non_causal in [
            ("flash_attention", "prefill", FLASH_PREFILL, 0, 0, bf16),
            ("flash_attention", "distill_teacher", DISTILL_TEACHER_ATTN, 0, 0, bf16),
            ("flash_attention_sm90_192", "deepseek_prefill", (*MLA_PREFILL, MLA_HV), 0, 0,
             bf16),
            ("flash_attention_sm90_112", "zamba2_prefill", ZAMBA2_PREFILL, 0, 0, bf16),
            ("flash_attention_tf32x3", "zamba2_prefill_fp32", ZAMBA2_PREFILL, 0, 0,
             torch.float32),
            ("flash_attention_decode", "zamba2_decode", ZAMBA2_DECODE, 63, 0, bf16),
            ("flash_attention_decode", "zamba2_decode", ZAMBA2_DECODE, 4095, 0, bf16),
            ("flash_attention_tf32x3", "deepseek_prefill_fp32", (*MLA_PREFILL, MLA_HV), 0, 0,
             torch.float32),
            ("flash_attention_decode", "decode", FLASH_DECODE, 63, 0, bf16),
            ("flash_attention_decode", "decode", FLASH_DECODE, 4095, 0, bf16),
            ("flash_attention_decode", "gemma3_decode_global", GEMMA3_DECODE, 63, 0, bf16),
            ("flash_attention_decode", "gemma3_decode_global", GEMMA3_DECODE, 4095, 0, bf16),
            ("flash_attention_decode", "gemma3_decode_local", GEMMA3_DECODE, 4095,
             GEMMA3_WINDOW, bf16),
            ("flash_attention_sm90_h256", "gemma3_global", GEMMA3_PREFILL, 0, 0, bf16),
            ("flash_attention_sm90_h256", "gemma3_local", GEMMA3_PREFILL, 0, GEMMA3_WINDOW,
             bf16),
            ("flash_attention_tf32x3", "prefill_fp32", FLASH_PREFILL, 0, 0, torch.float32),
            ("flash_attention_tf32x3", "reduced_fp32_b8", (8, *red), 0, 0, torch.float32),
            ("flash_attention_tf32x3", "reduced_fp32_b128", (128, *red), 0, 0,
             torch.float32),
            ("flash_attention_sm90_64", "whisper_encoder", WHISPER_ENCODER, 0, 0, bf16, False),
            ("flash_attention_sm90_64", "whisper_cross", WHISPER_CROSS, 0, 0, bf16, False),
            ("flash_attention_sm90_64", "whisper_self", WHISPER_SELF, 0, 0, bf16),
            ("flash_attention_decode", "whisper_decode", WHISPER_DECODE, 63, 0, bf16),
            ("flash_attention_decode", "whisper_decode", WHISPER_DECODE, 4095, 0, bf16),
            ("flash_attention_decode", "whisper_cross_decode", WHISPER_CROSS_DECODE, 0, 0,
             bf16, False)]:
        causal = not non_causal or non_causal[0]
        Hv = hv[0] if hv else H
        q, k, v = _attn_inputs(B, Sq, Sk, N, K, H, dtype, dev, Hv=Hv)
        # the keys some query sees: from the first query's window start
        lo = max(0, qo - window + 1) if window else 0
        n_keys = (min(Sk, qo + Sq) if causal else Sk) - lo
        size = q.element_size()
        nbytes = size * (B * Sq * N * (H + Hv) + B * n_keys * K * (H + Hv))
        flops = attention_flops(B, Sq, Sk, N, H, Hv, causal, window, qo)
        # fp32: three TF32 products a pair on the tensor cores (3xTF32)
        ops_, peak = (flops, BF16_OPS_PER_S) if dtype == bf16 else (3 * flops, TF32_OPS_PER_S)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if Sq == 1:
            kc, vc = kt[:, :, lo:lo + n_keys], vt[:, :, lo:lo + n_keys]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kc, vc, enable_gqa=True)
        elif window:
            i = torch.arange(Sq, device=dev)[:, None] + qo
            j = torch.arange(Sk, device=dev)[None, :]
            mask = (j <= i) & (j > i - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        shape = (f"q {(B, Sq, N, H)} kv {(B, Sk, K, H)}" + (f" v {Hv}" if Hv != H else "")
                 + f" q_offset={qo}" + (f" window={window}" if window else "")
                 + ("" if causal else " non-causal") + f" {str(dtype)[6:]}")
        plain = lambda: R.flash_attention_ref(q, k, v, causal=causal,  # noqa: E731
                                              window=window, q_offset=qo)
        launches = 5 if Sq * Sk >= 2**20 else TIMED_LAUNCHES  # 5 at a 4096-token prompt
        print(f"SDPA at {tag} {shape}: backend {sdpa_backend(lib)}")
        rows[(name, tag, qo)] = _timed(
            name, tag, shape,
            lambda: ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=qo),
            plain, lib, nbytes, ops_, peak, launches=launches)
        if dtype != bf16:
            fp32_bound, _ = bound_ms(nbytes, flops, FP32_OPS_PER_S)
            row = rows[(name, tag, qo)]
            print(f"  {name} {tag}: {row['bound_ms'] / row['ms']:.3f} of its bound "
                  f"({row['bound_by']}, 3xTF32); "
                  f"a kernel on the fp32 cores (2 (H + Hv) flops a pair at 67 TFLOP/s) is "
                  f"bound at {fp32_bound:.6f} ms")
        if name != "flash_attention_tf32x3":
            out = q.new_empty((B, Sq, N, Hv))
            tf32x3 = lambda: _lib.launch(  # noqa: E731
                "flash_attention", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, Sq, Sk, N, K, H, Hv, int(dtype == bf16), int(causal), window,
                qo, Sk, float(H**-0.5))
            rows[("flash_attention_tf32x3", tag, qo)] = _timed(
                "flash_attention_tf32x3", tag, shape, tf32x3, plain, lib, nbytes, ops_, peak,
                launches=launches)
            want = plain().float()
            if ((out.float() - want).abs() > BF16_ULP * want.abs() + 1e-6).any():
                fail(f"the tf32x3 flash_attention kernel disagrees at the {tag} shape, "
                     f"q_offset {qo}")
        del q, k, v, qt, kt, vt
    rows.update(time_latent_decode(dev))
    rows.update(time_rwkv_kernels(dev))
    return rows


def time_latent_decode(dev):
    """The latent decode kernel at deepseek-v2-lite-16b's serving decode:
    8 sequences, 16 heads, fp32 q (B, 1, 16, 576) against a bf16 4096-row
    cache (views of one buffer), at q_offset ``LATENT_TIMED`` (63 and 127,
    the middle and the end of ``serve``'s positions, and 4095, a full
    cache), device time through the CUDA-graph timer. The bound is the
    least time for the work: the cache rows the query sees (576 bf16
    values each), q and ctx once against 3.35 TB/s, or the operations,
    2 (576 + 512) flops a key and head, as fp32-accurate products on the
    tensor cores (three TF32 products at 495 TFLOP/s, as row 4b's bound)
    if that is longer; bytes bind at these shapes. The same operations on
    the fp32 cores (67 TFLOP/s, the SIMT kernel's bound) and as 3xTF32 are
    printed beside it. The library call is F.scaled_dot_product_attention
    in fp32 (TF32 off) on the same function: q against the rows up to
    q_offset as one kv head (``enable_gqa``), keys all 576 columns, values
    the first 512, scale 192^-0.5, the rows widened to fp32 once outside
    the timed call. These times are warm: the 37.7 MB cache stays in the 50
    MB L2 between launches. At 4095 the kernel is also timed cold, on
    ``LATENT_COLD_COPIES`` caches in turn (``cold_ms``), as a serving step
    finds each layer's cache."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import _latent_plan
    from repro_torch.kernels.flash_attention import latent_decode_flops

    rows = {}
    L, Rd = LATENT_DIMS
    B, S, N = 8, 4096, 16
    q, ckv, krope = _latent_inputs(B, S, N, torch.bfloat16, dev)
    for qo in LATENT_TIMED:
        n_keys = min(qo, S - 1) + 1
        nbytes = B * n_keys * (L + Rd) * 2 + B * N * (L + Rd) * 4 + B * N * L * 4
        flops = latent_decode_flops(B, N, S, L, Rd, qo)
        kv = torch.cat([ckv, krope], -1)[:, :n_keys].float()
        qt, kt, vt = q.transpose(1, 2), kv[:, None], kv[:, None, :, :L]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, scale=MLA_SCALE, enable_gqa=True)
        shape = f"q {(B, 1, N, L + Rd)} fp32, cache {(B, S, L + Rd)} bf16, q_offset={qo}"
        print(f"SDPA at latent_decode {shape}: backend {sdpa_backend(lib)}")
        rows[("flash_attention_latent_decode", "decode", qo)] = _timed(
            "flash_attention_latent_decode", "decode", shape,
            lambda: ops.latent_decode(q, ckv, krope, scale=MLA_SCALE, q_offset=qo),
            lambda: R.latent_decode_ref(q, ckv, krope, scale=MLA_SCALE, q_offset=qo),
            lib, nbytes, 3 * flops, TF32_OPS_PER_S)
        row = rows[("flash_attention_latent_decode", "decode", qo)]
        if qo == S - 1:
            caches = [(ckv, krope)] + [
                _latent_inputs(B, S, N, torch.bfloat16, dev, seed=1 + i)[1:]
                for i in range(LATENT_COLD_COPIES - 1)]
            turn = itertools.count()

            def cold():
                c, k = caches[next(turn) % len(caches)]
                ops.latent_decode(q, c, k, scale=MLA_SCALE, q_offset=qo)

            row["cold_ms"] = device_ms(cold)
            print(f"  latent_decode at q_offset {qo}, cold ({LATENT_COLD_COPIES} caches in "
                  f"turn): {row['cold_ms']:.5f} ms device, "
                  f"{row['bound_ms'] / row['cold_ms']:.3f} of its bound")
            del caches
        chunk, splits, vsplits = _latent_plan(B, S, qo)
        profile_phases(dev, f"latent_decode at q_offset {qo}",
                       lambda: ops.latent_decode(q, ckv, krope, scale=MLA_SCALE, q_offset=qo),
                       ("latent_decode_wgmma", "latent_decode_merge")[:1 + (splits > 1)])
        print(f"  latent_decode at q_offset {qo} (plan: chunk {chunk}, {splits} splits x "
              f"{vsplits} value-column groups, {B * splits * vsplits} blocks): "
              f"{row['bound_ms'] / row['ms']:.3f} of its bound ({row['bound_by']}); bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms, operations on the fp32 cores "
              f"{flops / FP32_OPS_PER_S * 1e3:.6f} ms, as 3xTF32 "
              f"{3 * flops / TF32_OPS_PER_S * 1e3:.6f} ms")
        del kv, qt, kt, vt
    del q, ckv, krope
    return rows


def time_rwkv_kernels(dev):
    """rwkv6_scan at the prefill and decode shapes through the wrapper (the
    chunked scan and the sequential kernel), and the sequential kernel,
    launched directly, at the prefill shape."""
    import torch

    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rwkv6_scan import _variant as _rwkv_variant
    from repro_torch.kernels.rwkv6_scan import scan_flops

    rows = {}
    for tag, (B, T, H, hd) in [("prefill", RWKV_PREFILL), ("decode", RWKV_DECODE)]:
        ins = _rwkv_inputs(B, T, H, hd, dev)
        shape = f"{(B, T, H, hd)} fp32"
        nbytes = 4 * (5 * B * T * H * hd + H * hd + 2 * B * H * hd * hd)
        flops = scan_flops(B, T, H, hd)
        n = 10 if tag == "prefill" else TIMED_LAUNCHES
        plain = lambda: R.rwkv6_scan_ref(*ins)  # noqa: E731
        name = "rwkv6_scan_chunked" if _rwkv_variant(T) == "chunked" else "rwkv6_scan"
        rows[(name, tag, None)] = _timed(name, tag, shape, lambda: ops.rwkv6_scan(*ins),
                                         plain, None, nbytes, flops, launches=n)
        if tag == "prefill":
            y, sT = torch.empty_like(ins[0]), torch.empty_like(ins[-1])
            seq = lambda: _lib.launch(  # noqa: E731
                "rwkv6_scan", dev, *(t.data_ptr() for t in ins), y.data_ptr(),
                sT.data_ptr(), B, T, H, hd)
            rows[("rwkv6_scan", tag, None)] = _timed(
                "rwkv6_scan", "prefill (seq, launched directly)", shape, seq, plain, None,
                nbytes, flops, launches=n)
            yr, sTr = plain()
            err = max((y - yr).abs().max().item(), (sT - sTr).abs().max().item())
            print(f"  the sequential kernel at the prefill shape: max|err| {err:.3e} "
                  f"{'ok' if err <= 3e-5 else 'MISMATCH'}")
            if err > 3e-5:
                fail("the sequential rwkv6_scan kernel disagrees at the prefill shape")
            profile_phases(dev, "rwkv6_scan_chunked", lambda: ops.rwkv6_scan(*ins),
                                ("local_pass", "chunk_scan", "correct"))
    rows[("rwkv6_scan_bwd", "train", None)] = time_rwkv_bwd(dev)
    return rows


def _rwkv_bwd_bounds(B, T, H, hd):
    """Bytes and fp32 operations the backward must move and do: r, k, v, w
    and dy read and dr, dk, dv and dw written once (36 hd bytes a token and
    head), u read and du written, s0 and dsT read and ds0 written; per token
    and head 14 hd^2 flops (an FMA as two: per state element 3 to recompute
    S_{t-1} = w S + k v, 3 to step G back, 2 each for dr, dk, dv and dw)
    and 12 hd (b_t and a_t, the bonus terms of dr, dk and dv, du). The
    kernel does the hd^2 part on the tensor cores as 3xTF32, so its JSON
    row prices these operations as row 4b does, three times over at TF32's
    peak; at fp32's (the earlier kernel's bound) they are printed beside
    it."""
    from repro_torch.kernels.rwkv6_scan import scan_grad_flops

    nbytes = 4 * (9 * B * T * H * hd + 2 * H * hd + 3 * B * H * hd * hd)
    return nbytes, scan_grad_flops(B, T, H, hd)


def _rwkv_bwd_design_bound(B, T, H, hd, C, L):
    """A diagnostic, not the row's bound: the least time of what
    ``csrc/rwkv6_scan_bwd.cu``'s design moves and does at chunks of C and
    sub-chunks of L (NQ = C / L): bytes, the function's plus its chunk
    scratch (two hd x hd matrices a chunk, written by ``local``, read and
    rewritten by ``chunk_scan``, read by ``grads``: 8 hd^2 floats a chunk,
    and P_end); operations, its GEMM flops ((10 + (NQ - 1) + 2 (NQ - 1) /
    NQ) hd^2 + 4 L hd a token and head) three times over as 3xTF32 at
    TF32's peak, plus its decayed parts ((3.5 L + 12) hd fp32 flops) at
    fp32's, the two units' times added. Returns (ms, "bytes" or
    "operations", bytes ms, tensor-core ms, fp32 ms)."""
    nq = C // L
    nc = B * H * -(-T // C)
    nbytes = _rwkv_bwd_bounds(B, T, H, hd)[0] + 4 * nc * (8 * hd * hd + 3 * hd)
    gemm = ((10 + (nq - 1) + 2 * (nq - 1) / nq) * hd * hd + 4 * L * hd) * B * T * H
    fp32 = (3.5 * L + 12) * hd * B * T * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc, t_fp = 3 * gemm / TF32_OPS_PER_S * 1e3, fp32 / FP32_OPS_PER_S * 1e3
    ops = t_tc + t_fp
    return max(t_bytes, ops), "bytes" if t_bytes >= ops else "operations", t_bytes, t_tc, t_fp


def time_rwkv_bwd(dev, launches=5):
    """The backward kernel at the training shape (one call: its three
    kernels) beside the plain backward; no single PyTorch call computes
    this function, so the library column is empty. The JSON row's bound
    prices the function's operations on the tensor cores as 3xTF32 (bytes
    bind it); printed beside it, the same operations on the fp32 cores
    and the floor of this design's traffic and work at its
    lengths (``_rwkv_bwd_design_bound``, a diagnostic)."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rwkv6_scan import BWD_SUB, _backward, _bwd_chunk

    B, T, H, hd = RWKV_TRAIN
    ins = _rwkv_inputs(B, T, H, hd, dev)
    dy, dsT = _rwkv_cotangents(B, T, H, hd, dev)
    nbytes, flops = _rwkv_bwd_bounds(B, T, H, hd)
    row = _timed("rwkv6_scan_bwd", "train", f"{RWKV_TRAIN} fp32",
                 lambda: _backward(*ins, dy, dsT),
                 lambda: R.rwkv6_scan_grad_ref(*ins, dy, dsT), None, nbytes, 3 * flops,
                 TF32_OPS_PER_S, launches=launches)
    fp32_bound, fp32_by = bound_ms(nbytes, flops, FP32_OPS_PER_S)
    C, L = _bwd_chunk(hd), BWD_SUB
    b, by, tb, ttc, tfp = _rwkv_bwd_design_bound(B, T, H, hd, C, L)
    print(f"rwkv6_scan_bwd at {RWKV_TRAIN}: bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}; its operations as 3xTF32 at TF32's peak); the same "
          f"operations on the fp32 cores {fp32_bound:.6f} ms ({fp32_by}); this design's "
          f"traffic and work at chunk {C}, sub-chunk {L} (a diagnostic): {b:.6f} ms ({by}: "
          f"bytes {tb:.6f}, tensor cores {ttc:.6f} + fp32 {tfp:.6f} ms)")
    profile_phases(dev, "rwkv6_scan_bwd", lambda: _backward(*ins, dy, dsT),
                        ("local", "chunk_scan", "grads"))
    return row


RWKV_CHUNKS = (16, 32, 64, 128)
RWKV_BWD_CHUNKS = (16, 32, 64, 128)  # chunk lengths of the backward kernel's sweep


def time_rwkv_chunks(dev):
    """``python3 chip_smoke.py --rwkv-chunks``: the chunked scan at the
    prefill shape, its C entry launched directly at each chunk length of
    ``RWKV_CHUNKS`` (the wrapper always passes ``CHUNK``), each held to the
    plain version at 3e-5: what ``CHUNK`` was chosen from."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R

    B, T, H, hd = RWKV_PREFILL
    ins = _rwkv_inputs(B, T, H, hd, dev)
    yr, sTr = R.rwkv6_scan_ref(*ins)
    y, sT, rp = torch.empty_like(ins[0]), torch.empty_like(ins[-1]), torch.empty_like(ins[0])
    for L in RWKV_CHUNKS:
        st = torch.empty((B, H, -(-T // L), hd, hd), device=dev)
        pend = torch.empty((B, H, -(-T // L), hd), device=dev)
        fn = lambda: _lib.launch(  # noqa: E731
            "rwkv6_scan_chunked", dev, *(t.data_ptr() for t in ins), y.data_ptr(),
            sT.data_ptr(), st.data_ptr(), rp.data_ptr(), pend.data_ptr(), B, T, H, hd, L,
            count_as="rwkv6_scan")
        fn()
        torch.cuda.synchronize()
        err = max((y - yr).abs().max().item(), (sT - sTr).abs().max().item())
        print(f"rwkv6_scan_chunked {RWKV_PREFILL} chunk {L}: {device_ms(fn, 10):.5f} ms "
              f"device, max|err| {err:.3e} {'ok' if err <= 3e-5 else 'MISMATCH'}")
        if err > 3e-5:
            fail(f"the chunked rwkv6_scan kernel disagrees at chunk {L}")
        del st, pend
    time_rwkv_bwd_chunks(dev)


def time_rwkv_bwd_chunks(dev):
    """The backward kernel at the training shape, its C entry launched
    directly at each chunk length of ``RWKV_BWD_CHUNKS`` (sub-chunks of
    ``BWD_SUB``, fixed in the kernel; the wrapper passes ``BWD_CHUNK``),
    each gradient held to the plain backward at 1e-4 of its max |g|, with
    the design's floor at that length: what ``BWD_CHUNK`` was chosen from.
    A length whose shared memory (``bwd_smem``) passes the card's opt-in
    limit is said so and not launched; any other failure fails the run."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.rwkv6_scan import BWD_SUB, bwd_smem

    B, T, H, hd = RWKV_TRAIN
    ins = _rwkv_inputs(B, T, H, hd, dev)
    dy, dsT = _rwkv_cotangents(B, T, H, hd, dev)
    want = R.rwkv6_scan_grad_ref(*ins, dy, dsT)
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    ds0 = torch.empty_like(ins[-1])
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for C in RWKV_BWD_CHUNKS:
        need = bwd_smem(hd, C)
        if need > limit:
            print(f"rwkv6_scan_bwd {RWKV_TRAIN} chunk {C}: needs {need} bytes of shared "
                  f"memory a block, over the card's {limit}: not launched")
            continue
        nc = -(-T // C)
        dup = torch.empty((B, H, nc, hd), device=dev)
        sx, gx = (torch.empty((B, H, nc, hd, hd), device=dev) for _ in range(2))
        pend = torch.empty_like(dup)
        fn = lambda: _lib.launch(  # noqa: E731
            "rwkv6_scan_bwd", dev, *(t.data_ptr() for t in (*ins, dy, dsT, *outs, dup, ds0,
                                                            sx, gx, pend)),
            B, T, H, hd, C)
        try:
            fn()
        except RuntimeError as e:
            fail(f"the rwkv6_scan backward kernel did not launch at chunk {C}: {e}")
        torch.cuda.synchronize()
        got = (*outs, dup.sum((0, 2)), ds0)
        share = max(((a - b).abs().max() / a.abs().max()).item() for a, b in zip(want, got))
        floor = _rwkv_bwd_design_bound(B, T, H, hd, C, BWD_SUB)[0]
        print(f"rwkv6_scan_bwd {RWKV_TRAIN} chunk {C} sub-chunk {BWD_SUB}: "
              f"{device_ms(fn, 5):.5f} ms device (design floor {floor:.6f} ms), worst "
              f"gradient {share:.3e} of its max|g| {'ok' if share <= 1e-4 else 'MISMATCH'}")
        if share > 1e-4:
            fail(f"the rwkv6_scan backward kernel disagrees at chunk {C}")
        del dup, sx, gx, pend


# A profiler window in a process that has run the profiler before loses its
# first kernel records, and more of them the more windows came before (7 by
# the kernel times once, 39 once the serving phase profiled decode steps of
# five models; the cause is not found, ROADMAP C14). So a window that counts
# launches opens with a lead-in of marker kernels (``spin_kernel``, which
# nothing else launches) and a sync, and is kept only if the profiler saw at
# least one marker: the loss then ended inside the lead-in. Otherwise it runs
# again with twice the lead-in.
PROFILE_LEAD_IN = 256
PROFILE_LEAD_IN_MAX = 1 << 15


def profile_kernels(dev, body, host_ops=True):
    """The device kernel records of ``body()`` under ``torch.profiler``,
    none lost to the loss above: (records, lead-in kernels launched,
    markers lost), each record (name, start ns, end ns), read from the
    profiler's raw records (building ``prof.events()``' tree of 16
    zamba2-7b decode steps took most of a minute). ``host_ops``: record
    host activity too. A window of device activity alone lost records
    inside it, not only at its start (16 zamba2-7b decode steps on an
    H100: 25.8 attention records a step of 26, 6,369.4 kernels of 6,440;
    ROADMAP C14), so only ``profile_dispatch``, whose rounds issue millions of host
    ops, leaves host activity out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = PROFILE_LEAD_IN
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    while True:
        torch.cuda.synchronize(dev)
        with profile(activities=activities) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize(dev)
            body()
            torch.cuda.synchronize(dev)
        records = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
        marks = sum("spin_kernel" in r[0] for r in records)
        if marks:
            return [r for r in records if "spin_kernel" not in r[0]], lead, lead - marks
        if lead >= PROFILE_LEAD_IN_MAX:
            fail(f"a profiler window lost all of a lead-in of {lead} kernels")
        lead *= 2


PROFILE_WINDOWS = 3  # windows profile_phases takes before it fails
# profile_phases' windows in this run: taken, and taken again because the
# profiler lost records inside one (ROADMAP C14's rate, printed at the end)
WINDOWS = {"taken": 0, "retaken": 0}


def profile_phases(dev, label, call, phases, calls=10):
    """Device ms per launch of each of ``call``'s kernels (``phases``, by a
    part of each kernel's name) under ``torch.profiler``, over ``calls``
    calls, in a window of ``profile_kernels``. The times are read only from
    a window in which the profiler saw exactly one launch of each kernel per
    call: a window that lost records inside it (ROADMAP C14: 8, 7 and 7 of
    10 rwkv6_scan_chunked launches in one run on an H100) is printed and
    taken again, up to ``PROFILE_WINDOWS`` windows; then it fails. The
    windows taken and taken again are counted in ``WINDOWS``, which the
    run prints among its last lines."""
    import torch

    call()
    torch.cuda.synchronize()

    def body():
        for _ in range(calls):
            call()

    for window in range(1, PROFILE_WINDOWS + 1):
        kernels, lead, lost = profile_kernels(dev, body)
        WINDOWS["taken"] += 1
        us = {p: [(t1 - t0) / 1e3 for n, t0, t1 in kernels if p in n] for p in phases}
        seen = {p: len(t) for p, t in us.items()}
        if all(n == calls for n in seen.values()):
            break
        WINDOWS["retaken"] += 1
        print(f"{label}: profiler window {window} saw {seen} kernels in {calls} calls "
              f"({lost} of a lead-in of {lead} lost), records lost inside it (ROADMAP C14)")
    else:
        fail(f"the profiler saw {seen} {label} kernels in {calls} calls, in each of "
             f"{PROFILE_WINDOWS} windows")
    print(f"{label} kernels, device ms per launch (profiler, {calls} calls, window {window}; "
          f"{len(kernels) - sum(seen.values())} other kernels seen; {lost} of a lead-in of "
          f"{lead} lost): "
          + ", ".join(f"{p} {sum(t) / len(t) / 1e3:.5f}" for p, t in us.items()))


LM_ARCHS = (("llama3.2-3b", 4096), ("rwkv6-1.6b", 1024))  # (arch, prefill step length)
# the GQA families: gemma3-12b's sliding-window layers (head_dim 256),
# nemotron-4-15b (LayerNorm, squared ReLU, G = 6), qwen2-moe-a2.7b's MoE
# blocks (G = 1) and llama3-8b; deepseek-v2-lite-16b's MLA; zamba2-7b's
# mamba2 blocks and shared attention block (head_dim 112); whisper-small's
# encoder-decoder (head_dim 64, non-causal encoder and cross attention) and
# llava-next-mistral-7b's media prefix (its prefill step 2048 media rows +
# 2048 tokens, ``input_specs``' split); ``--lm-families`` runs only these
LM_FAMILIES = (("gemma3-12b", 4096), ("nemotron-4-15b", 4096), ("qwen2-moe-a2.7b", 4096),
               ("llama3-8b", 4096), ("deepseek-v2-lite-16b", 4096), ("zamba2-7b", 4096),
               ("whisper-small", 4096), ("llava-next-mistral-7b", 4096))
# The served families' depth cut to keep the whole run within its time
# (the served repeats of each pattern; full width, every kernel instance a
# family launches still launched: gemma3-12b's local and global layers,
# deepseek-v2-lite-16b's dense mla head block and its mla_moe blocks). The
# models not named here are served at full depth.
SERVE_REPEATS = {"gemma3-12b": 2, "nemotron-4-15b": 8, "qwen2-moe-a2.7b": 8, "llama3-8b": 8,
                 "deepseek-v2-lite-16b": 8, "llava-next-mistral-7b": 8}


def served_config(arch):
    """``arch`` at full width, its depth cut to ``SERVE_REPEATS`` where it
    names the architecture."""
    from dataclasses import replace

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    if arch not in SERVE_REPEATS:
        return cfg
    n = SERVE_REPEATS[arch]
    return replace(cfg, n_repeats=n, num_layers=cfg.num_layers - len(cfg.pattern) * (
        cfg.n_repeats - n))
LM_SERVE = dict(num_requests=8, prompt_len=64, gen_len=64, cache_len=4096)


def expected_lm_launches(cfg):
    """Kernel launches of one serve run and one prefill step, from the
    layer list: each decode step and the prefill step run every layer once,
    an attention layer (``attn``, ``local_attn``, ``moe``, ``shared_attn``) or an MLA layer
    (``mla``, ``mla_moe``: the latent decode kernel at a decode step, the
    tensor-core kernel's (192, 128) instance at the prefill step, both
    counted as flash_attention) one flash_attention launch, each occurrence
    of a ``shared_attn`` block one flash_attention launch (zamba2-7b: 13 a
    step, at head_dim 112), an rwkv6 layer one rwkv6_scan launch; an
    encoder-decoder model's decoder layer one more flash_attention launch
    for its cross attention, and its encoder's layers one each at the
    prefill step alone (whisper-small: 24 a decode step, 36 at the prefill
    step); no other kernel of the repo (a ``moe`` or ``mla_moe`` block's
    routing and expert products, MLA's q_lat and ctx W_uv, and a ``mamba2``
    block, are torch ops and library products)."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import ATTN_KINDS, MLA_KINDS

    steps = LM_SERVE["prompt_len"] + LM_SERVE["gen_len"] + 1
    per_step = sum(b.kind in ATTN_KINDS + MLA_KINDS for b in cfg.blocks) * (1 + cfg.enc_dec)
    want = dict.fromkeys(ops.launches, 0)
    want["flash_attention"] = steps * per_step + cfg.enc_dec * cfg.enc_layers
    want["rwkv6_scan"] = steps * sum(b.kind == "rwkv6" for b in cfg.blocks)
    return want


def prefill_batch(cfg, batch, seq, dev, seed):
    """A random prefill batch with ``input_specs``' shapes: token ids in [1,
    vocab), media rows and encoder frames standard normal, from a numpy
    generator seeded with ``seed``."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import input_specs

    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in input_specs(cfg, batch, seq, "prefill").items():
        if spec.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(1, cfg.vocab_size, spec.shape)).to(dev)
        else:
            out[k] = torch.from_numpy(rng.standard_normal(spec.shape, np.float32)).to(
                dev, spec.dtype)
    return out


def drive_lm_path(dev, arch, prefill_len):
    """The LM serving path at full width and depth (``served_config``: some
    families' depth cut), bf16: ``serve`` as ``--full`` runs it, then one
    prefill step at batch 1 (``prefill_batch``: whisper-small's with 1500
    encoder frames, llava-next-mistral-7b's with its media rows)."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import sm90_launches, variant_launches
    from repro_torch.kernels.rwkv6_scan import variant_launches as rwkv_launches
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import default_opts, make_prefill_step
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.transformer import ATTN_KINDS, MLA_KINDS, init_params
    from repro_torch.tree import tree_leaves

    cfg = served_config(arch)
    kinds = {k: sum(b.kind == k for b in cfg.blocks) for k in dict.fromkeys(
        b.kind for b in cfg.blocks)}
    full = get_arch(arch).num_layers
    print(f"{arch}: {cfg.num_layers} layers" + (f" (of {full}: depth cut)" if
                                                 cfg.num_layers != full else "")
          + f" {kinds}, d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, {cfg.param_dtype}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve(cfg, use_reduced=False, device=dev, **LM_SERVE)
    serve_peak = torch.cuda.max_memory_allocated()
    serve_variants = dict(variant_launches)
    serve_rwkv = dict(rwkv_launches)

    opts = default_opts(cfg)
    base = torch.cuda.memory_allocated()  # the dry run's checks read peaks over this
    params = init_params(cfg, opts, seed=1, device=dev)
    print(f"{arch}: {sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B parameters "
          "served (a shared block once)")
    batch = prefill_batch(cfg, 1, prefill_len, dev, seed=1)
    print("prefill step batch: " + ", ".join(f"{k} {tuple(t.shape)} {str(t.dtype)[6:]}"
                                             for k, t in batch.items()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = make_prefill_step(cfg, opts)(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    CARD_PEAKS[f"{arch} prefill"] = torch.cuda.max_memory_allocated() - base
    want = expected_lm_launches(cfg)
    counts = dict(ops.launches)
    variants = dict(variant_launches)
    instances = dict(sm90_launches)
    # an encoder-decoder model's cross attention counts as an attention
    # layer of each decoder block, its encoder's layers at the prefill step
    n_attn = sum(b.kind in ATTN_KINDS for b in cfg.blocks) * (1 + cfg.enc_dec)
    n_enc = cfg.enc_dec * cfg.enc_layers
    n_mla = sum(b.kind in MLA_KINDS for b in cfg.blocks)
    decode_steps = LM_SERVE["prompt_len"] + LM_SERVE["gen_len"]
    # the prefill step's attention layers on the tensor-core kernel (at
    # head_dim 256 its own instance, MLA's expanded form on its (192, 128)
    # one, zamba2-7b's shared block on its (112, 112) one), the decode
    # steps' (Sq = 1) on the split-KV decode kernel, or for MLA on the
    # latent decode kernel, none on the 3xTF32 kernel (every serving model
    # is bf16 at (64, 64), (128, 128), (256, 256), (192, 128) or (112, 112))
    want_variants = {"sm90": n_attn + n_enc + n_mla, "tf32x3": 0,
                     "decode": decode_steps * n_attn, "latent_decode": decode_steps * n_mla}
    pairs = ([(cfg.head_dim, cfg.head_dim)] * (n_attn + n_enc)
             + [(cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)] * n_mla)
    want_instances = {h: pairs.count(h) for h in instances}
    # the prefill step's scans (T = prefill_len) on the chunked kernel, the
    # decode steps' (T = 1) on the sequential one
    rwkv = dict(rwkv_launches)
    n_rwkv = sum(b.kind == "rwkv6" for b in cfg.blocks)
    want_rwkv = {"seq": want["rwkv6_scan"] - n_rwkv, "chunked": n_rwkv}
    finite = bool(torch.isfinite(logits).all())
    peak = max(serve_peak, torch.cuda.max_memory_allocated())

    print(f"serve: decode-step prefill of {LM_SERVE['prompt_len']} tokens "
          f"{res.prefill_s:.4f} s; generation {res.gen_s:.4f} s, "
          f"{res.tokens_per_s:.2f} tokens/s, {res.ms_per_step:.4f} ms per decode step "
          f"(batch {LM_SERVE['num_requests']})")
    print(f"serve peak max_memory_allocated: {serve_peak / 2**20:.1f} MiB")
    print(f"prefill step (1, {prefill_len}): {prefill_s:.4f} s  "
          f"({prefill_len / prefill_s:.1f} tokens/s); logits {tuple(logits.shape)} "
          f"{logits.dtype}, finite {finite}")
    print(f"peak max_memory_allocated (serve + prefill step): {peak / 2**20:.1f} MiB")
    print(f"launches: {counts}  predicted from the layer list: {want}")
    print(f"flash_attention launches per kernel: {variants} (serve alone: {serve_variants}) "
          f" predicted: {want_variants}; tensor-core launches per head_dim {instances}, "
          f"predicted {want_instances}")
    n_moe = sum(b.kind == "moe" for b in cfg.blocks)
    if n_moe:
        print(f"{n_moe} moe blocks: their routing and expert products launch no kernel of "
              "the repo (every launch above is an attention layer's)")
    print(f"rwkv6_scan launches per kernel: {rwkv} (serve alone: {serve_rwkv})  "
          f"predicted: {want_rwkv}")
    V = cfg.vocab_size
    if res.tokens.shape != (LM_SERVE["num_requests"], LM_SERVE["gen_len"]):
        fail(f"{arch}: generated tokens have shape {res.tokens.shape}")
    if not ((res.tokens >= 0) & (res.tokens < V)).all():
        fail(f"{arch}: generated tokens outside [0, {V})")
    if not (res.logits_finite and finite):
        fail(f"{arch}: non-finite logits")
    if logits.shape != (1, padded_vocab(V)):
        fail(f"{arch}: prefill logits have shape {tuple(logits.shape)}")
    if counts != want:
        fail(f"{arch}: launches {counts}, the layer list predicts {want}")
    if variants != want_variants or serve_variants["sm90"] != 0 \
            or serve_variants["latent_decode"] != want_variants["latent_decode"]:
        fail(f"{arch}: flash_attention kernels {variants} (serve {serve_variants}), "
             f"predicted {want_variants}")
    if instances != want_instances:
        fail(f"{arch}: tensor-core instances {instances}, predicted {want_instances}")
    if rwkv != want_rwkv or serve_rwkv["chunked"] != 0:
        fail(f"{arch}: rwkv6_scan kernels {rwkv} (serve {serve_rwkv}), predicted {want_rwkv}")
    if max(counts.values()) <= 0:
        fail(f"{arch}: no kernel was launched on the serving path")
    CARD_PEAKS[f"{arch} decode"] = decode_peak(dev, cfg, opts, params, base)
    print(f"peaks over the {base / 2**20:.1f} MiB allocated before the params: prefill step "
          f"{CARD_PEAKS[f'{arch} prefill'] / 2**20:.1f} MiB, a decode step at "
          f"{LM_SERVE['cache_len'] - 1} of a full cache {CARD_PEAKS[f'{arch} decode'] / 2**20:.1f} "
          "MiB (held to the dry run later)")
    full_cache = time_decode_at(dev, cfg, opts, params, LM_SERVE["cache_len"] - 1) \
        if n_attn + n_mla else {}
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    # launches per JSON row's kernel: the tensor-core kernel's (256, 256),
    # (192, 128), (112, 112) and (64, 64) instances apart from its (128,
    # 128) one
    per_kernel = {**variants, **rwkv, "sm90": instances[(128, 128)],
                  "sm90_h256": instances[(256, 256)], "sm90_192": instances[(192, 128)],
                  "sm90_112": instances[(112, 112)], "sm90_64": instances[(64, 64)]}
    return counts, per_kernel, dict(
        serve_prefill_s=res.prefill_s, gen_s=res.gen_s, tokens_per_s=res.tokens_per_s,
        ms_per_step=res.ms_per_step, prefill_step_s=prefill_s, peak_mib=peak / 2**20,
        **full_cache)


def time_decode_at(dev, cfg, opts, params, pos, steps=16):
    """Greedy decode steps of the serving batch at position ``pos`` of a
    cache of ``LM_SERVE["cache_len"]`` filled with random values (each step
    rewrites slot ``pos`` and attends to every slot up to it): wall ms per
    step (host clock over ``steps`` steps, ending in a sync) and device ms
    per step (the union of kernel intervals under ``torch.profiler`` over as
    many steps, in a window of ``profile_kernels``: a marker lead-in, rerun
    with a doubled lead-in if every marker is lost, the lost count
    printed), with the attention kernel's device ms per step (the split-KV
    kernel's, or for MLA the latent decode kernel's). Its launches are not
    main-path launches: the counts are read before."""
    import gc

    import torch

    from repro_torch.fl.profile_round import busy_us
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import init_cache
    from repro_torch.tree import tree_leaves

    B, S = LM_SERVE["num_requests"], LM_SERVE["cache_len"]
    cache = init_cache(cfg, opts, B, S, getattr(torch, cfg.compute_dtype), device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for t in tree_leaves(cache):
        if t is not None:
            t.normal_(0.0, 0.5, generator=g)
    step = make_serve_step(cfg, opts)
    tok = torch.ones((B, 1), dtype=torch.long, device=dev)

    def run(n):
        nonlocal tok
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            nxt, _, _ = step(params, cache, {"token": tok, "pos": pos})
            tok = nxt[:, None].long()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    run(2)
    wall = run(steps)
    kernels, lead, lost = profile_kernels(dev, lambda: run(steps))
    if not kernels:
        fail("the profiler recorded no device activity in the decode steps")
    busy = busy_us([(t0, t1) for _, t0, t1 in kernels]) / 1e6 / steps
    attn = [(t0, t1) for n, t0, t1 in kernels if "flash_decode_" in n or "latent_decode_" in n]
    attn_ms = sum(t1 - t0 for t0, t1 in attn) / 1e6 / steps
    print(f"decode step at position {pos} of a full cache (batch {B}): {wall:.4f} ms wall "
          f"per step; device busy {busy:.4f} ms per step (profiler, union of kernel "
          f"intervals), idle share {1 - busy / wall:.4f}; decode attention "
          f"{attn_ms:.4f} ms per step in {len(attn) / steps:.1f} kernel records, "
          f"{attn_ms / busy:.4f} of device busy ({len(kernels) / steps:.1f} kernels per step; "
          f"{lost} of a lead-in of {lead} markers lost)")
    if not attn:
        fail("the decode steps at a full cache ran no decode attention kernel")
    del cache
    gc.collect()
    return dict(full_cache_wall_ms=wall, full_cache_busy_ms=busy, full_cache_attn_ms=attn_ms,
                full_cache_markers_lost=lost)


PARITY_WINDOW = 16  # the two-layer parity configs' sliding window, in tokens


def two_layer_config(arch):
    """``arch`` at full width in fp32, cut to two layers: two repeats of a
    one-block pattern, or its head block and one repeat (deepseek-v2-lite-16b:
    the dense ``mla`` layer and one ``mla_moe``), or, for gemma3-12b's (local
    x 5, global) pattern, its first and last blocks (one local and one
    global layer) with the window cut to ``PARITY_WINDOW`` tokens, so that a
    short run reaches past it; zamba2-7b's (mamba2 x 5, shared_attn)
    pattern to its first and last block, repeated twice (four layers, no
    tail); whisper-small's encoder cut to two layers as well."""
    from dataclasses import replace

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    cfg = replace(cfg, num_layers=2, param_dtype="float32", compute_dtype="float32",
                  enc_layers=min(cfg.enc_layers, 2))
    if len(cfg.pattern) == 1:
        return replace(cfg, n_repeats=2 - len(cfg.head_blocks))
    if any(b.shared for b in cfg.pattern):
        # zamba2-7b: (mamba2, shared_attn) twice, so two mamba2 blocks and
        # two occurrences of the one shared block, each with its own cache
        return replace(cfg, pattern=(cfg.pattern[0], cfg.pattern[-1]), n_repeats=2,
                       tail_blocks=(), num_layers=4)
    return replace(cfg, pattern=(cfg.pattern[0], cfg.pattern[-1]), n_repeats=1,
                   sliding_window=min(cfg.sliding_window, PARITY_WINDOW))


def parity_params(cfg, opts, seed, dev):
    """A parity config's parameters on the CPU, drawn on the card and
    copied: the CPU's ``trunc_normal_`` took most of a parity phase's
    time at a 256k-token vocabulary. An rwkv6 model's are drawn on the CPU,
    as before: on PR 29's card draw its training parity's worst leaf read
    1.001e-4 of its max|g|, fp32 noise of the chunked forward (ROADMAP C13),
    against the CPU draw's margin."""
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_map

    if any(b.kind == "rwkv6" for b in cfg.blocks):
        return init_params(cfg, opts, seed=seed, device="cpu")
    return tree_map(lambda t: t.cpu(), init_params(cfg, opts, seed=seed, device=dev))


def check_lm_parity(dev, arch):
    """Full width, two layers (``two_layer_config``), fp32, the same
    parameters on the card and on the CPU (``parity_params``): the same decode steps (2 requests,
    the same input tokens on both devices; 8, or 24 where a sliding window
    of 16 makes the later steps reach past it) and one 128-token prefill.
    Logits within 1e-4 of max|logit| (TF32 off: fp32 sums in other orders
    over d_model = 2048 to 8192); greedy tokens identical wherever the
    top-two margin exceeds that bound. An encoder-decoder model decodes
    against random encoder states (zeros would hide its cross attention),
    and its prompt has random frames; llava-next-mistral-7b's prompt is 64
    media rows and 64 tokens (``input_specs``' split of 128)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch.steps import default_opts, make_prefill_step, make_serve_step
    from repro_torch.models.transformer import init_cache
    from repro_torch.tree import tree_map

    cfg = two_layer_config(arch)
    opts = default_opts(cfg)
    n_steps = 24 if cfg.sliding_window else 8
    cpu = torch.device("cpu")
    rng = np.random.default_rng(2)
    steps = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, n_steps)))
    prompt = prefill_batch(cfg, 1, 128, cpu, seed=2)
    enc = torch.from_numpy(rng.standard_normal((2, cfg.enc_seq_len, cfg.d_model), np.float32))
    params = parity_params(cfg, opts, 3, dev)
    out = []
    for d in (dev, cpu):
        p = params if d == cpu else tree_map(lambda t: t.to(d), params)
        step = make_serve_step(cfg, opts)
        cache = init_cache(cfg, opts, 2, n_steps + 8, torch.float32, device=d)
        if cfg.enc_dec:
            cache["enc_out"].copy_(enc)
        logits = []
        for t in range(n_steps):
            _, lg, cache = step(p, cache, {"token": steps[:, t:t + 1].to(d), "pos": t})
            logits.append(lg.cpu())
        pre = make_prefill_step(cfg, opts)(p, {k: t.to(d) for k, t in prompt.items()}).cpu()
        out.append((torch.stack(logits), pre))
        del p, cache
    # the real vocabulary's logits: a padded one's masked columns (-inf
    # order of magnitude) would set the bound
    V = cfg.vocab_size
    (dec_g, pre_g), (dec_c, pre_c) = ((d[..., :V], p[..., :V]) for d, p in out)
    layers = "+".join(b.kind for b in cfg.blocks) + (
        f", window {cfg.sliding_window}" if cfg.sliding_window else "")
    for name, g, c in ((f"decode ({n_steps} steps)", dec_g, dec_c), ("prefill", pre_g, pre_c)):
        bound = 1e-4 * c.abs().max().item()
        err = (g - c).abs().max().item()
        top2 = c.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > bound
        same = bool((g.argmax(-1) == c.argmax(-1))[sure].all())
        print(f"{arch} {cfg.num_layers} layers ({layers}) fp32 {name}: logits max|card - CPU| "
              f"{err:.3e}, "
              f"bound {bound:.3e} (1e-4 of max|logit|); greedy tokens identical at "
              f"{int(sure.sum())} of {sure.numel()} positions with a margin above it: {same}")
        if err > bound or not same:
            fail(f"{arch}: the card's logits disagree with the CPU's ({name})")
    del params
    gc.collect()
    torch.cuda.empty_cache()


LM_TRAIN = dict(steps=4, batch=2, seq=1024)


def expected_train_launches(cfg) -> dict:
    """Kernel launches of ``LM_TRAIN``'s steps, from the layer list: a
    forward and a backward distill_loss launch (the CE entry) a loss chunk,
    and a step of an rwkv6 layer one ``rwkv6_scan`` forward (T = seq: the
    chunked kernel) and one backward launch; no attention kernel (training
    attention is ``mha`` under autograd)."""
    from repro_torch.launch.steps import default_opts

    steps = LM_TRAIN["steps"]
    loss = steps * (LM_TRAIN["seq"] // min(default_opts(cfg).loss_chunk, LM_TRAIN["seq"]))
    scans = steps * sum(b.kind == "rwkv6" for b in cfg.blocks)
    return {"distill_loss_fwd": loss, "distill_loss_bwd": loss, "flash_attention": 0,
            "flash_attention_empty_rows": 0, "skr_rectify": 0, "rwkv6_scan": scans,
            "rwkv6_scan_bwd": scans}


def drive_train_path(dev, arch="llama3.2-3b", cfg=None, remat=False):
    """The LM training path at ``arch``'s full width and depth (or at
    ``cfg``, a cut of it), bf16, as ``python -m repro_torch.launch.train
    --full --use-kernels`` runs it (``attn_chunk`` as ``train_lm`` sets it,
    ``remat`` as given), with the
    launch counters zeroed just before and read just after and held to
    ``expected_train_launches`` (the loss's through the CE entry, every scan
    forward on the chunked kernel). The last step runs under
    ``torch.profiler`` (``train_lm``'s ``profile_last``): device busy ms,
    idle share and the kernels that take the most device time."""
    import gc
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.distill_loss import variant_launches as distill_launches
    from repro_torch.kernels.rwkv6_scan import variant_launches as rwkv_launches
    from repro_torch.launch.train import PROFILE_LEAD_IN as TRAIN_LEAD_IN
    from repro_torch.launch.train import train_lm

    cfg = cfg or get_arch(arch)
    print(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B parameters by param_count(), {cfg.param_dtype}, "
          f"remat {remat}; {LM_TRAIN}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = train_lm(cfg, use_kernels=True, device=dev, log_every=1, profile_last=1,
                   remat=remat, **LM_TRAIN)
    want = expected_train_launches(cfg)
    counts = {k: ops.launches[k] for k in want}
    variants = dict(rwkv_launches)
    ce = {k: n for k, n in distill_launches.items() if n}
    add_variant_launches()
    peak = torch.cuda.max_memory_allocated()
    for i, (s_, loss, gn) in enumerate(zip(res.step_s, res.losses, res.grad_norms)):
        print(f"train step {i + 1}: {s_:.4f} s wall (ending in a sync"
              f"{', under the profiler' if i == LM_TRAIN['steps'] - 1 else ''}), "
              f"{res.tokens_per_s[i]:.1f} tokens/s, loss {loss:.5f}, grad norm {gn:.5f}")
    print(f"train step {LM_TRAIN['steps']} under torch.profiler: device busy "
          f"{1e3 * res.profile['busy_s']:.4f} ms, idle share {res.profile['idle_share']:.4f} "
          f"of step {LM_TRAIN['steps'] - 1}'s wall, "
          f"{res.profile['kernels_per_step']:.1f} kernels; {res.profile['markers_lost']} of "
          f"the window's lead-in of {TRAIN_LEAD_IN} markers lost")
    print(f"training peak max_memory_allocated: {peak / 2**20:.1f} MiB "
          f"({peak / 1e9:.2f} GB); {res.n_params / 1e9:.3f} B parameters stored, "
          f"{cfg.param_count() / 1e9:.3f} B by param_count()")
    print(f"launches: {counts}  predicted from the layer list: {want}")
    print(f"rwkv6_scan forward launches per kernel: {variants}; distill_loss launches per "
          f"entry and kernel: {ce}")
    if not res.profile["busy_s"] > 0:
        fail("the profiler recorded no device time in the training step")
    if res.profile["markers_lost"] >= TRAIN_LEAD_IN:
        fail("the training step's profiler window lost its whole lead-in: its first "
             "kernel records may be lost too (ROADMAP C14)")
    if not all(math.isfinite(v) for v in res.losses + res.grad_norms):
        fail(f"non-finite training loss or grad norm: {res.losses} {res.grad_norms}")
    if counts != want:
        fail(f"{arch} training: launches {counts}, predicted {want}")
    if variants != {"seq": 0, "chunked": want["rwkv6_scan"]}:
        fail(f"{arch} training: rwkv6_scan kernels {variants}")
    if sum(n for k, n in ce.items() if k.startswith("fwd_ce:")) != want["distill_loss_fwd"]:
        fail(f"{arch} training: the loss did not run on the CE entry alone: {ce}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants, res, peak


# zamba2-7b's training on one card: full width, R repeats of (mamba2 x 5,
# shared_attn) and the 3 tail mamba2 blocks, bf16, ``remat`` on. The depths
# the dry run traces on one card; the run takes the deepest whose traced
# peak leaves ZAMBA2_HEADROOM of the card free, and fails if its measured
# peak does not
ZAMBA2_DEPTHS = (10, 11, 12, 13)
ZAMBA2_HEADROOM = 4 * 2**30
MAMBA2_RANGE = "mamba2_block"  # the record_function range of a mamba2 mixer


def zamba2_train_config(repeats):
    """zamba2-7b at full width with ``repeats`` of its 13 repeats."""
    from dataclasses import replace

    from repro_torch.configs import get_arch

    cfg = get_arch("zamba2-7b")
    return replace(cfg, n_repeats=repeats,
                   num_layers=repeats * len(cfg.pattern) + len(cfg.tail_blocks))


def zamba2_depth(dev, cases=None) -> tuple[int, dict]:
    """Print the depths' table and return the deepest depth whose one-card
    record (``dryrun_case``'s "zamba2-7b train x R": the training step at
    2 x 1024 traced on ``meta``), on top of what earlier phases left
    allocated, leaves ``ZAMBA2_HEADROOM`` of the card's memory free, with
    its record. ``cases`` holds the dry run's records; without them the
    depths are traced here."""
    import torch

    from repro_torch.launch.dryrun import one_card

    total = torch.cuda.get_device_properties(dev).total_memory
    held = torch.cuda.memory_allocated(dev)
    fits = {}
    print(f"card memory {total / 1e9:.3f} GB ({total / 2**30:.2f} GiB); a peak must stay "
          f"under {(total - ZAMBA2_HEADROOM) / 1e9:.3f} GB; {held / 1e9:.3f} GB allocated "
          "before the run")
    for r in ZAMBA2_DEPTHS:
        label = f"zamba2-7b train x{r}"
        if cases:
            rec = cases[label]
        else:
            cfg, mode, batch, seq, opts, _ = dryrun_case(label)
            rec = one_card(cfg, mode, batch, seq, opts=opts, card_bytes=total)
        m = rec["memory"]
        print(f"  zamba2-7b, {r} repeats + 3 tail blocks: arguments (params, AdamW state, "
              f"batch) {m['argument_bytes'] / 1e9:.2f} GB, traced peak {m['peak_bytes'] / 1e9:.2f} "
              f"GB, fits one card {rec['fits_one_card']}")
        if held + m["peak_bytes"] <= total - ZAMBA2_HEADROOM:
            fits[r] = rec
    if not fits:
        fail(f"zamba2-7b: no depth of {ZAMBA2_DEPTHS} fits the card")
    return max(fits), fits[max(fits)]


@contextlib.contextmanager
def watch_unit_stacks(seen: list):
    """While open, every ``unbind`` with a gradient (``_backbone``'s split
    of the unit's stacked leaves into their repeats) records the device
    memory allocated just before its backward stacks the repeats'
    gradients into one leaf (``("before", bytes)``) and just after
    (``("after", bytes)``)."""
    from unittest import mock

    import torch

    unbind = torch.Tensor.unbind

    def watched(self, dim=0):
        parts = unbind(self, dim)
        if parts and parts[0].grad_fn is not None:
            node = parts[0].grad_fn
            node.register_prehook(
                lambda _: seen.append(("before", torch.cuda.memory_allocated())))
            node.register_hook(
                lambda *_: seen.append(("after", torch.cuda.memory_allocated())))
        return parts

    with mock.patch.object(torch.Tensor, "unbind", watched):
        yield


@contextlib.contextmanager
def mamba2_ranges():
    """While open, each mamba2 mixer runs inside a ``record_function``
    range named ``MAMBA2_RANGE``: its forward (the recompute of a
    checkpointed repeat included) and its backward, from its output's
    gradient to its input's (the range opened and closed by tensor hooks,
    on the autograd thread), so that ``train_lm``'s profile gives the
    mixers' device time (``ranges``)."""
    from unittest import mock

    from torch.autograd.profiler import record_function

    from repro_torch.models import ssm as S

    block = S.mamba2_block

    def ranged(cfg, p, x, state):
        with record_function(MAMBA2_RANGE):
            y, st = block(cfg, p, x, state)
        if y.requires_grad and x.requires_grad:
            rf = record_function(MAMBA2_RANGE)

            def enter(_):
                rf.__enter__()

            def leave(_):
                rf.__exit__(None, None, None)

            y.register_hook(enter)
            x.register_hook(leave)
        return y, st

    with mock.patch.object(S, "mamba2_block", ranged):
        yield


def drive_zamba2_train(dev):
    """zamba2-7b's training path (``drive_train_path`` at
    ``zamba2_train_config(zamba2_depth())``, ``remat`` on): the launches
    held to the layer list (the loss's CE entry, nothing else), the peak
    held ``ZAMBA2_HEADROOM`` under the card's memory; beside them the
    memory allocated just before and after the unit's gradient is stacked,
    and the profiled step's device time in the mamba2 mixers."""
    import gc

    import torch

    gc.collect()
    repeats, reckoned = zamba2_depth(dev, DRYRUN["cases"])
    cfg = zamba2_train_config(repeats)
    print(f"zamba2-7b training at {repeats} of 13 repeats + 3 tail blocks "
          f"({cfg.num_layers} of 81 layers), full width")
    seen = []
    with watch_unit_stacks(seen), mamba2_ranges():
        counts, _, res, peak = drive_train_path(dev, "zamba2-7b", cfg=cfg, remat=True)
    total = torch.cuda.get_device_properties(dev).total_memory
    before = max(b for k, b in seen if k == "before")
    after = max(b for k, b in seen if k == "after")
    mixers = res.profile["ranges"].get(MAMBA2_RANGE, 0.0)
    retries = torch.cuda.memory_stats(dev)["num_alloc_retries"]
    print(f"the unit's gradient ({sum(k == 'before' for k, _ in seen)} stacks over "
          f"{LM_TRAIN['steps']} steps): {before / 1e9:.2f} GB allocated before a stack at "
          f"most, {after / 1e9:.2f} GB just after one at most; the step's peak "
          f"{peak / 1e9:.2f} GB, traced {reckoned['memory']['peak_bytes'] / 1e9:.2f} GB; "
          f"{retries} allocations retried after freeing the allocator's cache")
    print(f"mamba2 mixers in the profiled step: {1e3 * mixers:.4f} ms of "
          f"{1e3 * res.profile['busy_s']:.4f} busy ms ({mixers / res.profile['busy_s']:.4f}); "
          f"record_function ranges {res.profile['ranges']}")
    if peak > total - ZAMBA2_HEADROOM:
        fail(f"zamba2-7b training at {repeats} repeats: peak {peak / 1e9:.2f} GB, over the "
             f"card's {total / 1e9:.2f} GB less {ZAMBA2_HEADROOM / 2**30:.0f} GiB")
    if not mixers > 0:
        fail("the profiled step attributed no device time to the mamba2 mixers")
    return counts, res, peak


def measure_zamba2_depths(dev):
    """``python3 chip_smoke.py --zamba2-depths``: two training steps at each
    depth of ``ZAMBA2_DEPTHS`` (bf16, ``remat`` on, 2 x 1024 tokens), the
    measured peak beside the dry run's traced one; a depth that runs out
    of memory is said to."""
    import gc

    import torch

    from repro_torch.launch.dryrun import one_card
    from repro_torch.launch.train import train_lm

    total = torch.cuda.get_device_properties(dev).total_memory
    for r in ZAMBA2_DEPTHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        label = f"zamba2-7b train x{r}"
        cfg, mode, batch, seq, opts, _ = dryrun_case(label)
        traced = one_card(cfg, mode, batch, seq, opts=opts, card_bytes=total)
        traced = traced["memory"]["peak_bytes"]
        try:
            res = train_lm(zamba2_train_config(r), steps=2, batch=2, seq=1024, use_kernels=True,
                           remat=True, device=dev, log_every=1)
        except torch.OutOfMemoryError:
            print(f"zamba2-7b at {r} repeats: out of memory (traced peak "
                  f"{traced / 1e9:.2f} GB of {total / 1e9:.2f})")
            continue
        peak = torch.cuda.max_memory_allocated()
        print(f"zamba2-7b at {r} repeats: peak {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB), "
              f"{(total - peak) / 2**30:.2f} GiB free; traced {traced / 1e9:.2f} GB; "
              f"steps {res.step_s} s, losses {res.losses}")
        del res


# ------------------------------------------------------- the sharding plane

# The dry run is traced on the host's cores before the first timed phase,
# in worker processes that never touch the card, so that no host-bound
# time of a later phase shares the host with it; CARD_PEAKS holds the
# serving phases' measured peaks for the check against the card
DRYRUN: dict = {"records": None, "cases": None}
DRYRUN_MESHES = (("1x1", {"card": True}), ("16x16", {"multi_pod": False}),
                 ("2x16x16", {"multi_pod": True}))
CARD_PEAKS: dict[str, int] = {}
MESH_BATCH = 2  # rows of the batch-leading tree the mesh phase averages
MESH_PHASE = ("mesh: make_host_mesh() on NCCL, (1, 1) and (1, 1, 1); hier_grad_mean and "
              "edge_only_mean over llama3.2-3b's parameters, batch 2, bf16, vs mean(0)")
DRYRUN_PHASE = ("dry run: run_one for 10 architectures x 4 input shapes on 1x1, 16x16 and "
                "2x16x16, and the one-card records of the card checks")
DRYRUN_CARD_PHASE = ("dry run against the card: each traced one-card peak vs "
                     "max_memory_allocated over one step")


def train_opts(cfg, remat):
    """``train_lm``'s options, the training phases': attention without
    chunks, the loss through distill_loss's CE entry, ``remat`` as given."""
    from repro_torch.launch.steps import default_opts

    return default_opts(cfg, attn_chunk=0, remat=remat, use_kernels=True)


def dryrun_labels() -> list[str]:
    """The one-card cases the card checks read besides the 40 pairs:
    zamba2-7b's training step at each depth of ``ZAMBA2_DEPTHS``, the
    training phases' llama3.2-3b and rwkv6-1.6b steps, and each served
    model's prefill and decode step."""
    labels = [f"zamba2-7b train x{r}" for r in ZAMBA2_DEPTHS]
    labels += [f"{arch} train" for arch, _ in LM_ARCHS]
    for arch, _ in LM_ARCHS + LM_FAMILIES:
        labels += [f"{arch} prefill", f"{arch} decode"]
    return labels


def dryrun_case(label):
    """(cfg, mode, batch, seq, opts, pos) of a ``dryrun_labels`` case, as
    the phase that runs it on the card runs it: training at 2 x 1024 with
    ``train_opts`` (zamba2-7b with ``remat`` at its depth), a prefill step
    at batch 1 of the serving phase's length, a decode step of its 8
    requests at position 4095 of a 4096-long cache, both at the served
    depth (``served_config``) with ``default_opts``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import default_opts

    arch, kind, *rest = label.split(" ")
    if kind == "train":
        cfg = zamba2_train_config(int(rest[0][1:])) if rest else get_arch(arch)
        return (cfg, "train", LM_TRAIN["batch"], LM_TRAIN["seq"], train_opts(cfg, bool(rest)),
                None)
    cfg = served_config(arch)
    if kind == "prefill":
        return cfg, "prefill", 1, dict(LM_ARCHS + LM_FAMILIES)[arch], default_opts(cfg), None
    B, S = LM_SERVE["num_requests"], LM_SERVE["cache_len"]
    return cfg, "decode", B, S, default_opts(cfg), S - 1


def dryrun_work() -> list[tuple]:
    """The dry run's items, the dearest first: ("case", label) for each of
    ``dryrun_labels``, then ("record", mesh, arch, shape) for 10
    architectures x 4 input shapes on each of ``DRYRUN_MESHES``."""
    from repro_torch.configs import INPUT_SHAPES, list_archs

    return ([("case", label) for label in dryrun_labels()]
            + [("record", m, a, s) for m, _ in DRYRUN_MESHES for a in list_archs()
               for s in INPUT_SHAPES])


def _dryrun_worker() -> None:
    """A dry-run worker: the card hidden, one thread."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    torch.set_num_threads(1)


def _dryrun_item(item, card_bytes: int) -> dict:
    """One item of ``dryrun_work``, in a worker: ``run_one`` for a record
    (1x1 against ``card_bytes``), ``one_card`` for a case."""
    from repro_torch.launch import dryrun as D

    if item[0] == "record":
        _, mesh, arch, shape = item
        return D.run_one(arch, shape, **dict(DRYRUN_MESHES)[mesh], out_dir=None,
                         card_bytes=card_bytes)
    cfg, mode, batch, seq, opts, pos = dryrun_case(item[1])
    return D.one_card(cfg, mode, batch, seq, opts=opts, pos=pos, card_bytes=card_bytes)


def run_dryrun(dev) -> tuple[list, dict]:
    """Trace ``dryrun_work`` over a worker process a host core (spawned,
    the card hidden, one thread each); fail on any failed item or on a
    status other than ``shape_skip_reason``'s; print a line a record as the
    reference's CLI does, a line a case, and the one-card table (peak,
    whether it fits) of the 40 pairs."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import record_line, shape_skip_reason

    total = torch.cuda.get_device_properties(dev).total_memory
    work = dryrun_work()
    workers = len(os.sched_getaffinity(0))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_dryrun_worker) as pool:
        futures = [pool.submit(_dryrun_item, item, total) for item in work]
        done, failed = [], []
        for item, fut in zip(work, futures):
            try:
                done.append(fut.result())
            except Exception as e:  # noqa: BLE001 - every failure is reported
                failed.append(item)
                print(f"[FAIL] {item}: {type(e).__name__}: {e}")
    print(f"dry run: {len(work)} items over {workers} worker processes (card memory {total} "
          f"bytes) in {time.perf_counter() - t0:.1f} s, {len(failed)} failed")
    if failed:
        fail(f"the dry run: {len(failed)} items failed")
    records = [rec for item, rec in zip(work, done) if item[0] == "record"]
    cases = {item[1]: rec for item, rec in zip(work, done) if item[0] == "case"}
    for rec in records:
        print(record_line(rec))
        skip = shape_skip_reason(get_arch(rec["arch"]), rec["shape"], False)
        if (rec["status"], rec.get("reason")) != (("skipped", skip) if skip else ("ok", None)):
            fail(f"the dry run: {rec['arch']} {rec['shape']} {rec['mesh']} is {rec['status']}, "
                 f"shape_skip_reason says {skip!r}")
    for label, rec in cases.items():
        m = rec["memory"]
        print(f"[OK]   {label:32s} trace {rec['trace_s']:6.1f}s arg "
              f"{m['argument_bytes'] / 1e9:7.2f}GB peak {m['peak_bytes'] / 1e9:7.2f}GB "
              f"flops {rec['cost']['flops']:.4g}")
    print("one card (1x1), 4 GiB of headroom: peak GB, fits")
    for rec in records:
        if rec["mesh"] == "1x1":
            what = (f"{rec['memory']['peak_bytes'] / 1e9:10.2f} "
                    f"{'fits' if rec['fits_one_card'] else 'does not fit'}"
                    if rec["status"] == "ok" else "skipped")
            print(f"  {rec['arch']:24s} {rec['shape']:12s} {what}")
    DRYRUN.update(records=records, cases=cases)
    return records, cases


def check_mesh(dev) -> None:
    """``make_host_mesh()`` on the card (a one-rank NCCL group on an
    in-process store), as (1, 1) over ("data", "model") and (1, 1, 1) over
    ("pod", "data", "model"); ``hier_grad_mean`` and ``edge_only_mean``
    over a batch-leading tree shaped as llama3.2-3b's parameters, full
    width, bf16, ``MESH_BATCH`` rows, each held bit for bit to the flat
    ``mean(0)``; the group is destroyed after."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import axis_sizes, make_host_mesh
    from repro_torch.launch.steps import default_opts, param_shapes
    from repro_torch.sharding.hierarchy import edge_only_mean, hier_grad_mean
    from repro_torch.tree import tree_leaves, tree_map

    meshes = (make_host_mesh(device=dev), make_host_mesh(pod=1, device=dev))
    print(f"process group: backend {dist.get_backend()}, world size {dist.get_world_size()}; "
          f"meshes {[axis_sizes(m) for m in meshes]}")
    if dist.get_backend() != "nccl":
        fail(f"the card's mesh runs on {dist.get_backend()}, not NCCL")
    cfg = get_arch("llama3.2-3b")
    g = torch.Generator(device=dev).manual_seed(5)
    tree = tree_map(lambda t: torch.randn((MESH_BATCH,) + tuple(t.shape), generator=g,
                                          device=dev).to(torch.bfloat16),
                    param_shapes(cfg, default_opts(cfg)))
    leaves = tree_leaves(tree)
    print(f"tree: {len(leaves)} leaves, {sum(t.numel() * 2 for t in leaves) / 1e9:.2f} GB")
    flat = [t.mean(0) for t in leaves]
    for mesh in meshes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hier = tree_leaves(hier_grad_mean(tree, mesh))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bad = sum(not torch.equal(a, b) for a, b in zip(hier, flat))
        del hier
        edge = [e.full_tensor() if isinstance(e, DTensor) else e[None]
                for e in tree_leaves(edge_only_mean(tree, mesh))]
        torch.cuda.synchronize()
        bad += sum(e.shape != (1,) + f.shape or not torch.equal(e[0], f)
                   for e, f in zip(edge, flat))
        kind = "DTensor over pod" if "pod" in axis_sizes(mesh) else "plain"
        del edge
        print(f"mesh {axis_sizes(mesh)}: hier_grad_mean {t1 - t0:.3f} s, edge_only_mean "
              f"({kind}); leaves not equal to mean(0) bit for bit: {bad}")
        if bad:
            fail(f"the two-tier mean on the mesh {axis_sizes(mesh)} is not mean(0) bit for bit")
    del tree, leaves, flat
    dist.destroy_process_group()


def decode_peak(dev, cfg, opts, params, base) -> int:
    """One decode step of the serving batch at position 4095 of a 4096-long
    cache: ``max_memory_allocated`` over ``base`` (the bytes allocated
    before the params), the peak stats reset just before the step."""
    import gc

    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import init_cache

    B, S = LM_SERVE["num_requests"], LM_SERVE["cache_len"]
    cache = init_cache(cfg, opts, B, S, getattr(torch, cfg.compute_dtype), device=dev)
    tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    make_serve_step(cfg, opts)(params, cache, {"token": tok, "pos": S - 1})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del cache
    gc.collect()
    return peak


def check_dryrun_on_card(dev, measure_serving=False) -> None:
    """Each one-card record held to the card: reset the peak stats, run
    the one step, and hold ``max_memory_allocated`` over what was
    allocated before its arguments to the record's ``peak_bytes``, within
    5% or 512 MiB (``dryrun.within_bar``). (a) zamba2-7b's training step
    at 10, 11 and 12 repeats, the record saying 13 does not fit; (b)
    llama3.2-3b's and rwkv6-1.6b's; (c) each served model's prefill and
    decode step (measured in the serving phases, ``CARD_PEAKS``, or here
    with ``measure_serving``); (d) every input-shape pair the one-card
    record says fits, at its own batch and length, full width and
    depth."""
    import gc

    import torch

    from repro_torch.configs import INPUT_SHAPES, get_arch
    from repro_torch.launch.dryrun import measure_on_card, within_bar
    from repro_torch.launch.steps import default_opts

    records, cases = DRYRUN["records"], DRYRUN["cases"]
    rows = []

    def hold(label, rec, measured, step_s=None):
        want = rec["memory"]["peak_bytes"]
        ok = within_bar(measured, want)
        rows.append((label, ok))
        print(f"  {label:40s} traced {want / 1e9:8.3f} GB  measured {measured / 1e9:8.3f} GB  "
              f"{(measured - want) / 2**20:+9.1f} MiB ({(measured - want) / want:+.4f})  "
              f"{'inside' if ok else 'OUTSIDE'} the bar"
              + (f"  step {step_s:.3f} s" if step_s is not None else ""), flush=True)

    def run(label, cfg, mode, batch, seq, opts, pos=None):
        m = measure_on_card(cfg, mode, batch, seq, opts=opts, pos=pos, device=dev)
        out = m["out"]  # the metrics, the logits, or the next token and the logits
        out = out.values() if isinstance(out, dict) else out if isinstance(out, tuple) else [out]
        if not all(bool(torch.isfinite(t).all()) for t in out if t.is_floating_point()):
            fail(f"{label}: the step on the card gave non-finite outputs")
        del m["out"]
        gc.collect()
        torch.cuda.empty_cache()
        return m

    print("(a) zamba2-7b training, 2 x 1024, remat, at each depth")
    for r in ZAMBA2_DEPTHS:
        label = f"zamba2-7b train x{r}"
        rec = cases[label]
        if r == ZAMBA2_DEPTHS[-1]:
            print(f"  {label:40s} traced {rec['memory']['peak_bytes'] / 1e9:8.3f} GB: fits one "
                  f"card {rec['fits_one_card']} (not run)")
            if rec["fits_one_card"]:
                fail(f"the dry run says zamba2-7b fits at {r} repeats")
            continue
        if not rec["fits_one_card"]:
            fail(f"the dry run says zamba2-7b does not fit at {r} repeats")
        m = run(label, *dryrun_case(label))
        hold(label, rec, m["peak_bytes"], m["step_s"])
    print("(b) the training phases' steps, 2 x 1024")
    for arch, _ in LM_ARCHS:
        label = f"{arch} train"
        m = run(label, *dryrun_case(label))
        hold(label, cases[label], m["peak_bytes"], m["step_s"])
    print("(c) each served model's prefill step and decode step at 4095 (served depths)")
    for arch, _ in LM_ARCHS + LM_FAMILIES:
        for kind in ("prefill", "decode"):
            label = f"{arch} {kind}"
            if measure_serving:
                m = run(label, *dryrun_case(label))
                CARD_PEAKS[label] = m["peak_bytes"]
            if label not in CARD_PEAKS:
                fail(f"{label}: no peak measured on the card")
            hold(label, cases[label], CARD_PEAKS[label])
    print("(d) every input-shape pair that fits one card, its own batch and length, full "
          "width and depth")
    fitting = [r for r in records if r["mesh"] == "1x1" and r["status"] == "ok"
               and r["fits_one_card"]]
    for rec in fitting:
        label = f"{rec['arch']} {rec['shape']}"
        cfg, shape = get_arch(rec["arch"]), INPUT_SHAPES[rec["shape"]]
        m = run(label, cfg, shape.mode, shape.global_batch, shape.seq_len, default_opts(cfg))
        hold(label, rec, m["peak_bytes"], m["step_s"])
    outside = [label for label, ok in rows if not ok]
    print(f"{len(rows)} cases, {len(outside)} outside 5% or 512 MiB: {outside}")
    if outside:
        fail(f"traced one-card peaks miss the card's: {outside}")


RWKV_PARITY_SETTINGS = ((0, 0), (0, 32), (16, 32))  # (rwkv_chunk, ssm_seq_chunk)
ZAMBA2_PARITY_SETTINGS = ((0, 0), (0, 32))


def _router_leaves(tree) -> list:
    """The ``moe`` blocks' router leaves of a parameter or gradient tree."""
    blocks = [*tree["head_blocks"], *tree["unit"].values(), *tree["tail_blocks"]]
    return [b["moe"]["router"] for b in blocks if "moe" in b]


def check_train_parity(dev, arch="llama3.2-3b", settings=((0, 0),)):
    """``arch`` at full width, two layers (``two_layer_config``), fp32
    (the same params on both devices, ``parity_params``), one
    ``make_train_step`` with the loss through
    ``use_kernels`` on the card, and on the CPU the gradient of the same
    ``forward_train`` (whose loss and ``clip_by_global_norm`` norm are what
    the CPU's ``make_train_step`` reports, without a second backward pass),
    from one ``token_batches``
    batch of 2 x 64, at each (rwkv_chunk, ssm_seq_chunk) of ``settings``:
    loss within 1e-5 relative, grad norm within 1e-4 relative, every
    gradient leaf within 1e-4 of that leaf's max |g| (TF32 off: fp32 sums in
    other orders over d_model, d_ff and the vocabulary). Params are not
    compared after the step: AdamW's first step moves each element by about
    lr * sign(g), and signs of gradients below the fp32 noise flip between
    devices (ROADMAP C4). A model with a stubbed frontend gets its inputs
    beside the tokens, standard normal from a seeded numpy generator
    (whisper-small's 1500 encoder frames, so that the encoder's gradient is
    held too). On the card, also the loss with ``use_kernels`` on
    against off, within 1e-5 relative. For rwkv6 the line gives the card's
    scan launches: forward and backward kernels where the time mix runs the
    scan (the sequence chunks' recompute adds forward launches), none where
    ``rwkv_chunk`` sends it through the chunked torch form. For an MoE
    model the line also gives the router losses on both devices (each
    within 1e-5 relative) and the router's gradient leaves' worst share;
    for a model with a shared block (zamba2-7b: one copy, its gradient
    summed over its occurrences), the shared leaves' worst share."""
    import gc
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.data.loader import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import default_opts, make_train_step
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models.transformer import forward_train
    from repro_torch.optim import adamw_init, clip_by_global_norm
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad

    cfg = two_layer_config(arch)
    moe = any(b.kind in ("moe", "mla_moe") for b in cfg.blocks)
    rwkv = any(b.kind == "rwkv6" for b in cfg.blocks)
    cpu = torch.device("cpu")
    params = parity_params(cfg, default_opts(cfg), 5, dev)
    shared = [i for i, n in enumerate(_leaf_names(params)) if n.startswith("shared/")]
    b = next(token_batches(np.random.default_rng(6), cfg.vocab_size, 2, 64))
    stubs = {k: torch.from_numpy(np.random.default_rng(7).standard_normal(t.shape, np.float32))
             for k, t in stub_inputs(cfg, 2, "meta").items()}
    for rwkv_chunk, ssm_seq_chunk in settings:
        opts = default_opts(cfg, attn_chunk=0, remat=False, use_kernels=True,
                            rwkv_chunk=rwkv_chunk, ssm_seq_chunk=ssm_seq_chunk)
        out = []
        for d in (dev, cpu):
            p = tree_map(lambda t: t.to(d, copy=True), params)
            batch = {k: torch.from_numpy(v).to(d, torch.int64) for k, v in b.items()}
            batch.update({k: t.to(d) for k, t in stubs.items()})
            ops.reset_launches()
            loss, g = value_and_grad(lambda pp: forward_train(cfg, opts, pp, batch)[0], p)
            # the CPU's make_train_step would compute this gradient again: its
            # loss and grad norm are this loss and clip_by_global_norm's norm
            norm = clip_by_global_norm(g, 1.0)[1] if d == cpu else None
            routers = [t.cpu() for t in _router_leaves(g)]
            g = [t.cpu() for t in tree_leaves(g)]
            if moe:
                with torch.no_grad():
                    aux = {k: float(v) for k, v in
                           forward_train(cfg, opts, p, batch)[1].items() if k != "ce"}
            if d == dev:
                scans = {k: ops.launches[k] for k in ("rwkv6_scan", "rwkv6_scan_bwd")}
                ce = {k: ops.launches[k] for k in ("distill_loss_fwd", "distill_loss_bwd")}
                with torch.no_grad():
                    plain = forward_train(cfg, replace(opts, use_kernels=False), p, batch)[0]
                loss_plain = float(plain)
            if d == dev:
                _, _, m = make_train_step(cfg, opts, lr=1e-4)(p, adamw_init(p), batch)
                loss, norm = m["loss"], m["grad_norm"]
            out.append((float(loss), float(norm), g, routers, aux if moe else {}))
            del p, batch
            gc.collect()
        (lg, ng, gg, rg, ag), (lc, nc, gc_, rc, ac) = out

        shares = _leaf_shares(gc_, gg)
        share = max(shares)
        worst_leaf = _leaf_names(params)[shares.index(share)]
        tag = (f" rwkv_chunk {rwkv_chunk} ssm_seq_chunk {ssm_seq_chunk}"
               if len(settings) > 1 else "")
        layers = "+".join(b.kind for b in cfg.blocks) + (
            f", window {cfg.sliding_window}" if cfg.sliding_window else "")
        print(f"{arch} 2 layers ({layers}) fp32 train step{tag}: loss {lg:.7f} (card) "
              f"{lc:.7f} (CPU); grad norm {ng:.7f} (card) {nc:.7f} (CPU); worst gradient leaf "
              f"max|card - CPU| {share:.3e} of its max|g| ({worst_leaf}); card loss with "
              f"use_kernels off "
              f"{loss_plain:.7f}"
              + (f"; card scan launches in the gradient {scans}" if rwkv else "")
              + (f"; the shared block's {len(shared)} leaves' worst "
                 f"{max(shares[i] for i in shared):.3e} of max|g|; card CE launches in the "
                 f"gradient {ce}" if shared else "")
              + (f"; router losses {ag} (card) {ac} (CPU); the routers' gradient leaves' "
                 f"worst {max(_leaf_shares(rc, rg)):.3e} of max|g|" if moe else ""))
        if abs(lg - lc) > 1e-5 * abs(lc) or abs(ng - nc) > 1e-4 * abs(nc) or share > 1e-4:
            fail(f"{arch}{tag}: the card's training step disagrees with the CPU's")
        if any(abs(ag[k] - ac[k]) > 1e-5 * abs(ac[k]) for k in ac):
            fail(f"{arch}: the card's router losses {ag} disagree with the CPU's {ac}")
        if abs(lg - loss_plain) > 1e-5 * abs(loss_plain):
            fail(f"{arch}{tag}: the card's training loss differs between use_kernels on "
                 "and off")
        if rwkv and (scans["rwkv6_scan_bwd"] > 0) != (rwkv_chunk == 0):
            fail(f"{arch}{tag}: scan launches {scans} in the gradient")
        del out
        gc.collect()
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _leaf_names(tree, prefix="") -> list:
    """Each leaf's path in ``tree_leaves`` order, as "unit/blk0/rwkv/wr"."""
    if isinstance(tree, dict):
        return [n for k in tree for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix[1:]]


def _leaf_shares(want, got) -> list:
    """Per leaf, max|got - want| as a fraction of max|want|."""
    return [((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()
            for a, b in zip(want, got)]


def diagnose_train_parity(dev, arch="rwkv6-1.6b"):
    """ROADMAP C13: ``check_train_parity``'s gradients (``arch`` at full
    width, two layers, fp32, seed 5, settings (0, 0)) leaf by leaf, for
    parameters drawn on the CPU and drawn on the card (each then copied to
    both devices). For each draw, each leaf's max|card - CPU| as a fraction
    of its max|g|: the card through the scan's kernels (as the check runs
    it), the card with the scan's plain version under autograd
    (``ref.rwkv6_scan_ref``: no kernel of the repo on the scan), and the
    CPU with one thread against the CPU with all of them (fp32 sums in
    other orders, no card at all); and, to tell the scan's two kernels
    apart, the card with the forward kernel and the plain backward
    (``ref.rwkv6_scan_grad_ref``) and with the plain forward and the
    backward kernel. A leaf whose share is of one size in all of them is
    fp32 noise of that leaf, not a kernel's."""
    import contextlib
    import gc
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.data.loader import token_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rwkv6_scan as RS
    from repro_torch.launch.steps import default_opts
    from repro_torch.models.transformer import forward_train, init_params
    from repro_torch.tree import tree_leaves, tree_map, value_and_grad

    cfg = two_layer_config(arch)
    opts = default_opts(cfg, attn_chunk=0, remat=False, use_kernels=True)
    b = next(token_batches(np.random.default_rng(6), cfg.vocab_size, 2, 64))
    cpu = torch.device("cpu")

    def grads(params, d, plain_scan=False, threads=None, plain=None):
        p = tree_map(lambda t: t.to(d, copy=True), params)
        batch = {k: torch.from_numpy(v).to(d, torch.int64) for k, v in b.items()}
        if plain_scan:
            scan = mock.patch.object(ops, "rwkv6_scan", lambda *a: R.rwkv6_scan_ref(*a))
        elif plain == "backward":
            scan = mock.patch.object(RS, "_backward", lambda *a: R.rwkv6_scan_grad_ref(*a))
        elif plain == "forward":
            scan = mock.patch.object(RS, "_forward", lambda *a: R.rwkv6_scan_ref(*a))
        else:
            scan = contextlib.nullcontext()
        n = torch.get_num_threads()
        if threads:
            torch.set_num_threads(threads)
        try:
            with scan:
                _, g = value_and_grad(lambda pp: forward_train(cfg, opts, pp, batch)[0], p)
        finally:
            torch.set_num_threads(n)
        return [t.cpu() for t in tree_leaves(g)]

    for draw in ("cpu", "card"):
        params = init_params(cfg, opts, seed=5, device=cpu if draw == "cpu" else dev)
        params = tree_map(lambda t: t.cpu(), params)
        names = _leaf_names(params)
        want = grads(params, cpu)
        runs = {"card, kernels": grads(params, dev),
                "card, plain scan": grads(params, dev, plain_scan=True),
                "CPU, 1 thread": grads(params, cpu, threads=1),
                "card, forward kernel + plain backward": grads(params, dev, plain="backward"),
                "card, plain forward + backward kernel": grads(params, dev, plain="forward")}
        shares = {k: _leaf_shares(want, g) for k, g in runs.items()}
        print(f"{arch} 2 layers fp32, parameters drawn on the {draw}: each gradient leaf's "
              f"max|x - CPU| / max|g| for x = " + ", ".join(shares))
        order = sorted(range(len(names)), key=lambda i: -shares["card, kernels"][i])
        for i in order:
            print(f"  {names[i]:40s} max|g| {want[i].abs().max().item():.3e}  "
                  + "  ".join(f"{v[i]:.3e}" for v in shares.values()))
        for k, v in shares.items():
            j = v.index(max(v))
            print(f"  worst, {k}: {names[j]} {v[j]:.3e}")
        scan_error_against_fp64(dev, cfg, opts, params, b)
        del params, want, runs
        gc.collect()
    torch.cuda.empty_cache()


def scan_error_against_fp64(dev, cfg, opts, params, b):
    """Each rwkv6 layer's scan inputs in a forward pass on the card; per
    layer, y of the forward kernel (the chunked scan at T 64), of the plain
    fp32 recurrence on the card and on the CPU, each against the same
    recurrence in fp64: max|y - y64| / max|y64|."""
    from unittest import mock

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rwkv6_scan as RS
    from repro_torch.models.transformer import forward_train
    from repro_torch.tree import tree_map

    seen, scan = [], ops.rwkv6_scan

    def record(*ins):
        seen.append(tuple(t.detach().clone() for t in ins))
        return scan(*ins)

    p = tree_map(lambda t: t.to(dev), params)
    batch = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in b.items()}
    with torch.no_grad(), mock.patch.object(ops, "rwkv6_scan", record):
        forward_train(cfg, opts, p, batch)
    for layer, ins in enumerate(seen):
        y64, _ = R.rwkv6_scan_ref(*ins, dtype=torch.float64)
        scale = y64.abs().max().item()
        got = {"forward kernel": RS._forward(*ins)[0],
               "plain, card": R.rwkv6_scan_ref(*ins)[0],
               "plain, CPU": R.rwkv6_scan_ref(*(t.cpu() for t in ins))[0]}
        print(f"  layer {layer} scan y against fp64 (max|y64| {scale:.3e}): "
              + ", ".join(f"{k} {(g.double().cpu() - y64.cpu()).abs().max().item() / scale:.3e}"
                          for k, g in got.items()))
    del p, seen


def time_train_loss_kernels(dev):
    """distill_loss at the training shape, bf16 logits: the CE entry (the
    one the training loss runs) and the t entry at beta = 0 (what the
    training loss launched, on an all-zero t, before the CE entry existed;
    its time does not depend on t's values), forward
    and backward device ms beside the plain versions and, for the
    forwards, ``F.cross_entropy`` on the same bf16 logits. The bound counts
    the bytes each entry moves (z, and t for the t entry, read once; dz
    written once; in bf16) and 16 bytes a row of labels, stats, loss and
    cotangent, against 3.35 TB/s; the fp32 operations against 67 TFLOP/s.
    Then the CE entry at zamba2-7b's training shape (V 32,000), the same."""
    import torch

    B, N, V = TRAIN_LOSS_SHAPE
    rows = time_distill(dev, "train", B, N, V, torch.bfloat16, [("ce", 0.0), ("t", 0.0)],
                        launches=20)
    print("distill_loss at the training shape: "
          + json.dumps({f"{k[0]} beta={k[2]}": v for k, v in rows.items()}))
    zamba2 = time_distill(dev, "train_zamba2", *ZAMBA2_LOSS_SHAPE, torch.bfloat16,
                          [("ce", 0.0)], launches=20)
    print("distill_loss's CE entry at zamba2-7b's training shape: "
          + json.dumps({f"{k[0]} beta={k[2]}": v for k, v in zamba2.items()}))
    return {**rows, **zamba2}


# The LM distillation path (``repro_torch.examples.train_lm_distill``):
# llama3.2-3b teaches llama3-8b over the shared 128,256-token vocabulary,
# the teacher at full width and depth, the student at full width and
# ``SERVE_REPEATS``' depth (8 of 32 layers: full depth's bf16 params,
# gradients and fp32 moments alone are 96 GB), bf16, the example's steps of
# B x S tokens
DISTILL_PAIR = ("llama3.2-3b", "llama3-8b")
DISTILL_STEPS = 20
DISTILL_PHASE = ("LM distillation path: llama3.2-3b (full depth) teaches llama3-8b (8 of 32 "
                 f"layers), full width, bf16, {DISTILL_STEPS} steps")
DISTILL_PARITY_PHASE = ("LM distillation parity: llama3.2-3b teaches llama3-8b, full width, "
                        "two layers each, fp32, one step, the card vs the CPU")
SERVE_DECODE_PHASE = "serve_decode example: rwkv6-1.6b reduced, on the card"
ADAMW_MARK = "distribution_elementwise"  # the uniform_ kernel that marks AdamW's start


def expected_distill_launches(teacher_cfg, steps) -> dict:
    """Kernel launches of ``steps`` distillation steps, from the layer list:
    a step's teacher forward one flash_attention launch an attention layer
    (bf16 prefill of S tokens), one launch of SKR's fused entry, and one
    forward and one backward launch of distill_loss's t entry; the
    student's attention is ``mha`` under autograd, no kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import ATTN_KINDS

    want = dict.fromkeys(ops.launches, 0)
    want.update(distill_loss_fwd=steps, distill_loss_bwd=steps, skr_rectify=steps,
                flash_attention=steps * sum(b.kind in ATTN_KINDS for b in teacher_cfg.blocks))
    return want


def profile_distill_step(dev, teacher_cfg, student_cfg, pt, ps, skr) -> None:
    """One distillation step (the teacher's knowledge, the student's
    gradient, AdamW) under ``torch.profiler`` in a window of
    ``profile_kernels``, after one step outside it: device busy ms (the
    union of kernel intervals) and the device ms and share of busy of SKR's
    fused entry, distill_loss's two launches, the teacher's attention and
    AdamW's passes (every kernel after a ``uniform_`` kernel launched
    between the gradient and the update). A window that lost one of these
    records (ROADMAP C14) is taken again, up to ``PROFILE_WINDOWS``."""
    import re

    import torch

    from repro_torch.examples import train_lm_distill as D
    from repro_torch.fl.profile_round import busy_us
    from repro_torch.models.transformer import ATTN_KINDS
    from repro_torch.optim import adamw_init, adamw_update_

    vocab = min(teacher_cfg.vocab_size, student_cfg.vocab_size)
    ot, os_ = D.pair_opts(teacher_cfg), D.pair_opts(student_cfg)
    opt = adamw_init(ps)
    tokens, labels = (torch.from_numpy(a).to(dev, torch.int64)
                      for a in next(D.token_draws(vocab, 1)))
    state = {"skr": skr}

    def step():
        tlogq, state["skr"] = D.teach(teacher_cfg, ot, pt, state["skr"], tokens, labels, vocab)
        _, grads = D.student_grads(student_cfg, os_, ps, tokens, labels, tlogq, vocab)
        torch.empty(1, device=dev).uniform_()
        adamw_update_(grads, opt, ps, lr=D.LR, weight_decay=0.0)

    step()
    torch.cuda.synchronize()
    parts = {"skr": lambda n: "skr_process_kernel" in n,
             "distill_loss": lambda n: re.search(r"\b(fwd_regs|fwd_stream|bwd)<", n),
             "attention": lambda n: "flash_sm90_kernel" in n,
             "mark": lambda n: ADAMW_MARK in n}
    want = {"skr": 1, "distill_loss": 2, "mark": 1,
            "attention": sum(b.kind in ATTN_KINDS for b in teacher_cfg.blocks)}
    for window in range(1, PROFILE_WINDOWS + 1):
        kernels, lead, lost = profile_kernels(dev, step)
        WINDOWS["taken"] += 1
        got = {p: [(t0, t1) for n, t0, t1 in kernels if match(n)] for p, match in parts.items()}
        seen = {p: len(v) for p, v in got.items()}
        if seen == want:
            break
        WINDOWS["retaken"] += 1
        print(f"distillation step: profiler window {window} saw {seen} kernels, want {want} "
              f"({lost} of a lead-in of {lead} lost), records lost inside it (ROADMAP C14)")
    else:
        fail(f"the profiler saw {seen} of the distillation step's kernels, want {want}, in "
             f"each of {PROFILE_WINDOWS} windows")
    busy = busy_us([(t0, t1) for _, t0, t1 in kernels]) / 1e6
    mark_end = got["mark"][0][1]
    adamw = [(t0, t1) for _, t0, t1 in kernels if t0 >= mark_end]
    ms = {p: sum(t1 - t0 for t0, t1 in v) / 1e6 for p, v in got.items() if p != "mark"}
    ms["adamw"] = busy_us(adamw) / 1e6
    top: dict[str, float] = {}
    for n, t0, t1 in kernels:
        top[n[:60]] = top.get(n[:60], 0.0) + (t1 - t0) / 1e6
    print(f"one distillation step under torch.profiler (window {window}): device busy "
          f"{busy:.4f} ms, {len(kernels)} kernels ({lost} of a lead-in of {lead} markers "
          f"lost); " + ", ".join(f"{p} {m:.4f} ms ({m / busy:.4f} of busy)"
                                 for p, m in ms.items())
          + f" (AdamW: {len(adamw)} kernels)")
    print("  top kernels by device ms: " + "; ".join(
        f"{n} {m:.4f}" for n, m in sorted(top.items(), key=lambda kv: -kv[1])[:6]))
    if not busy > 0:
        fail("the profiler recorded no device time in the distillation step")
    del opt


def drive_distill_path(dev):
    """The LM distillation path, ``train_lm_distill.run`` on the card at the
    published widths (``DISTILL_PAIR``: the student's depth cut), bf16
    weights, fp32 from the logits on, with the launch counters zeroed just
    before and read just after, held to ``expected_distill_launches``:
    distill_loss's t entry on the ``stream`` forward and the ``slices``
    backward (V = 128,256 in fp32), SKR's fused entry, the teacher's
    attention on the tensor-core kernel's (128, 128) instance. Prints each
    step's wall ms (ends in a sync), the peak memory, the losses and SKR's
    pushes and rectified rows, then one more step under the profiler.
    Returns the launches and the tensor-core (128, 128) launches."""
    import gc
    import math
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.examples import train_lm_distill as D
    from repro_torch.kernels import ops
    from repro_torch.kernels.distill_loss import variant_launches as distill_launches
    from repro_torch.kernels.flash_attention import sm90_launches
    from repro_torch.kernels.flash_attention import variant_launches as flash_launches
    from repro_torch.kernels.skr_rectify import variant_launches as skr_launches
    from repro_torch.models.transformer import init_params

    tcfg, scfg = get_arch(DISTILL_PAIR[0]), served_config(DISTILL_PAIR[1])
    vocab = min(tcfg.vocab_size, scfg.vocab_size)
    for role, cfg in (("teacher", tcfg), ("student", scfg)):
        print(f"{role} {cfg.name}: {cfg.num_layers} of {get_arch(cfg.name).num_layers} layers, "
              f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.head_dim}, {cfg.param_count() / 1e9:.3f} B parameters, {cfg.param_dtype}")
    print(f"{DISTILL_STEPS} steps of B {D.B} x S {D.S} tokens, V {vocab}, T {D.TEMP}, "
          f"beta {D.BETA}, SKR queues of {D.QUEUE_LEN}; AdamW lr {D.LR}, fp32 moments")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pt = init_params(tcfg, D.pair_opts(tcfg), seed=0, device=dev)
    ps = init_params(scfg, D.pair_opts(scfg), seed=1, device=dev)
    ops.reset_launches()
    res = D.run(tcfg, scfg, steps=DISTILL_STEPS, pt=pt, ps=ps, device=dev)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    distill = {k: n for k, n in distill_launches.items() if n}
    skr = dict(skr_launches)
    flash = dict(flash_launches)
    instances = {h: n for h, n in sm90_launches.items() if n}
    add_variant_launches()
    peak = torch.cuda.max_memory_allocated()
    want = expected_distill_launches(tcfg, DISTILL_STEPS)
    n = DISTILL_STEPS
    want_flash = {"sm90": want["flash_attention"], "tf32x3": 0, "decode": 0,
                  "latent_decode": 0}
    want_instances = {(tcfg.head_dim, tcfg.head_dim): want["flash_attention"]}
    ms = [1e3 * s for s in res.step_s]
    rows = n * D.B * D.S
    print("step wall ms (host clock, ending in a sync): " + ", ".join(f"{m:.2f}" for m in ms)
          + f"; median {statistics.median(ms):.4f}, of steps 2-{n} "
          f"{statistics.median(ms[1:]):.4f}")
    print(f"peak max_memory_allocated: {peak / 2**20:.1f} MiB ({peak / 1e9:.2f} GB)")
    print("losses: " + ", ".join(f"{x:.5f}" for x in res.losses))
    print(f"SKR: {sum(res.pushes)} queue pushes and {sum(res.rectified)} rows rectified in "
          f"{rows} rows (per step {res.pushes}, {res.rectified}); final state: "
          f"{int((res.skr['count'] > 0).sum())} classes with a queue, counts summing to "
          f"{int(res.skr['count'].sum())}")
    print(f"launches: {counts}  predicted from the layer list: {want}")
    print(f"distill_loss launches per entry and kernel: {distill}; skr_rectify per entry: "
          f"{skr}; flash_attention per kernel: {flash}, tensor-core instances {instances}")
    if len(res.losses) != n or not all(math.isfinite(x) for x in res.losses):
        fail(f"distillation: non-finite or missing losses {res.losses}")
    if counts != want:
        fail(f"distillation: launches {counts}, predicted {want}")
    if distill != {"fwd:stream": n, "bwd:slices": n}:
        fail(f"distillation: distill_loss kernels {distill}, want {n} fwd:stream and "
             f"{n} bwd:slices")
    if skr != {"map": 0, "fused": n}:
        fail(f"distillation: skr_rectify entries {skr}, want {n} fused")
    if flash != want_flash or instances != want_instances:
        fail(f"distillation: flash_attention {flash} {instances}, predicted {want_flash} "
             f"{want_instances}")
    if int(res.skr["count"].max()) < D.QUEUE_LEN and int(res.skr["count"].sum()) != sum(
            res.pushes):
        fail(f"distillation: SKR's queue counts sum to {int(res.skr['count'].sum())}, "
             f"{sum(res.pushes)} rows pushed")
    profile_distill_step(dev, tcfg, scfg, pt, res.params, res.skr)
    del pt, ps, res
    gc.collect()
    torch.cuda.empty_cache()
    return counts, instances.get((128, 128), 0)


def check_distill_parity(dev):
    """The distillation step at the published widths, two layers each
    (``two_layer_config``), fp32, params drawn on the card (the CPU's
    generator takes tens of seconds for their 2.1 B values) and copied to
    the CPU, one ``token_draws`` batch, and a queue state with 1-20 entries on
    every class the labels name (so that Eq. 31 fires on each misattributed
    row): the teacher's logits and knowledge and the student's loss and
    gradient on each device (TF32 off). Bars: the teacher's fp32 logits
    within 1e-5 of max|z| (sums of 3,072 products in other orders; the LM
    parities hold logits to 1e-4); the card's logits through the CPU's
    softmax, SKR and log within 1e-5 of the card's tlogq, with the same
    queue state; each device's tlogq from its own logits within 4 max|dz|
    / T + 1e-5 of the other's (log softmax(z / T) moves by at most 2
    max|dz| / T, and Eq. 31's log(1 - p_c) by at most as much again, since
    a misattributed row has p_c < 1/2); SKR's count and head exact and q
    within 1e-6; the loss within 1e-5 relative; each gradient leaf within
    1e-4 of its max|g|."""
    import gc

    import numpy as np
    import torch

    from repro_torch.core.skr import skr_init
    from repro_torch.examples import train_lm_distill as D
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_leaves, tree_map

    tcfg, scfg = (two_layer_config(a) for a in DISTILL_PAIR)
    vocab = min(tcfg.vocab_size, scfg.vocab_size)
    ot, os_ = D.pair_opts(tcfg), D.pair_opts(scfg)
    cpu = torch.device("cpu")
    on_card = (init_params(tcfg, ot, seed=8, device=dev), init_params(scfg, os_, seed=9,
                                                                      device=dev))
    on_cpu = tuple(tree_map(lambda t: t.cpu(), p) for p in on_card)
    tokens, labels = (torch.from_numpy(a).long() for a in next(D.token_draws(vocab, 1)))
    rows = labels.reshape(-1)
    skr = skr_init(vocab, D.QUEUE_LEN)
    rng = np.random.default_rng(10)
    cls = labels.unique()
    skr["q"][cls] = torch.from_numpy(rng.uniform(0.1, 0.9, (len(cls), D.QUEUE_LEN))
                                     .astype(np.float32))
    skr["count"][cls] = torch.from_numpy(rng.integers(1, D.QUEUE_LEN + 1, len(cls))
                                         .astype(np.int32))
    skr["head"][cls] = torch.from_numpy(rng.integers(0, D.QUEUE_LEN, len(cls))
                                        .astype(np.int32))
    out = []
    for d, (p_t, p_s) in ((dev, on_card), (cpu, on_cpu)):
        def to(t):
            return t.to(d, copy=True)

        tok, lab = tokens.to(d), labels.to(d)
        # teacher_knowledge, its logits kept
        with torch.no_grad():
            z = D.logits_fn(tcfg, ot, p_t, tok, train=False)[..., :vocab].float()
        probs, q, state = D.knowledge(tree_map(to, skr), z.reshape(-1, vocab), rows.to(d))
        tlogq = D.log_knowledge(q)
        loss, grads = D.student_grads(scfg, os_, p_s, tok, lab, tlogq, vocab)
        pushed = int((probs.gather(1, rows.to(d)[:, None])[:, 0] >= probs.amax(1)).sum())
        out.append((z.reshape(-1, vocab).cpu(), tlogq.cpu(),
                    {k: v.cpu() for k, v in state.items()}, float(loss),
                    [g.cpu() for g in tree_leaves(grads)], pushed,
                    int((q != probs).any(1).sum())))
        del p_t, p_s, z, probs, q, state, tlogq, grads
        gc.collect()
    (zg, tg, sg, lg, gg, pg, rg), (zc, tc, sc, lc, gc_, pc, rc) = out
    _, q_same, s_same = D.knowledge(skr, zg, rows)
    same_err = (D.log_knowledge(q_same) - tg).abs().max().item()
    z_err, z_bound = (zg - zc).abs().max().item(), 1e-5 * zc.abs().max().item()
    t_err, t_bound = (tg - tc).abs().max().item(), 4 * z_err / D.TEMP + 1e-5
    q_err = (sg["q"] - sc["q"]).abs().max().item()
    same = all(torch.equal(sg[k], sc[k]) and torch.equal(sg[k], s_same[k])
               for k in ("count", "head"))
    q_err = max(q_err, (sg["q"] - s_same["q"]).abs().max().item())
    shares = _leaf_shares(gc_, gg)
    share = max(shares)
    worst = _leaf_names(on_cpu[1])[shares.index(share)]
    print(f"{tcfg.name} -> {scfg.name}, two layers each, fp32, V {vocab}: teacher logits "
          f"max|card - CPU| {z_err:.3e} (bound {z_bound:.3e}, 1e-5 of max|z|); tlogq from "
          f"the card's logits max|card - CPU| {same_err:.3e} (bound 1e-5); tlogq from each "
          f"device's logits max|card - CPU| {t_err:.3e} (bound {t_bound:.3e}, 4 max|dz| / T "
          f"+ 1e-5); SKR count/head {'exact' if same else 'MISMATCH'}, q max|err| "
          f"{q_err:.3e} (bound 1e-6); rows pushed {pg} (card) {pc} (CPU), rectified {rg} "
          f"(card) {rc} (CPU) of {len(tg)}; loss {lg:.7f} (card) {lc:.7f} (CPU); worst "
          f"gradient leaf max|card - CPU| {share:.3e} of its max|g| ({worst})")
    if z_err > z_bound:
        fail("distillation: the card's teacher logits disagree with the CPU's")
    if same_err > 1e-5 or t_err > t_bound or not same or q_err > 1e-6:
        fail("distillation: the card's teacher knowledge or SKR state disagrees with the CPU's")
    if abs(lg - lc) > 1e-5 * abs(lc) or share > 1e-4:
        fail("distillation: the card's student loss or gradient disagrees with the CPU's")
    if rc == 0 or (pg, rg) != (pc, rc):
        fail(f"distillation parity: rows pushed {pg} / {pc}, rectified {rg} / {rc}")
    del on_card, on_cpu, out
    gc.collect()
    torch.cuda.empty_cache()


def drive_serve_decode(dev) -> int:
    """``serve_decode.main(["rwkv6-1.6b"])`` on the card (its default
    device), with the launch counters zeroed before and read after: the
    (requests, gen_len) tokens in the vocabulary and one sequential
    rwkv6_scan launch a layer and serve step (prompt + generated tokens),
    no other kernel. Returns those launches."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.examples import serve_decode
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6_scan import variant_launches as rwkv_launches

    cfg = reduced(get_arch("rwkv6-1.6b"))
    ops.reset_launches()
    res = serve_decode.main(["rwkv6-1.6b"])
    torch.cuda.synchronize()
    counts, rwkv = dict(ops.launches), dict(rwkv_launches)
    n = (serve_decode.PROMPT_LEN + serve_decode.GEN_LEN) * sum(
        b.kind == "rwkv6" for b in cfg.blocks)
    want = dict.fromkeys(ops.launches, 0)
    want["rwkv6_scan"] = n
    print(f"serve_decode: tokens {res.tokens.shape}, launches {counts} (predicted {want}), "
          f"rwkv6_scan per kernel {rwkv}")
    if res.tokens.shape != (serve_decode.REQUESTS, serve_decode.GEN_LEN) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
        fail(f"serve_decode: tokens {res.tokens}")
    if counts != want or rwkv != {"seq": n, "chunked": 0}:
        fail(f"serve_decode: launches {counts} {rwkv}, predicted {want}")
    return n


def run_baselines_phases(dev) -> dict:
    """The baselines' main path, their card-vs-CPU step parity, the hierfavg
    gate signatures and resume on the card; returns the main path's
    distill_loss launches."""
    phase("baselines main path: run_experiment(name, FLConfig()) for "
          + ", ".join(f"{n} ({r} round{'s' * (r > 1)})" for n, r in BASELINE_RUNS))
    counts = drive_baselines_path(dev)
    phase("baseline parity: one local step, the card vs the CPU")
    check_baseline_step_parity(dev)
    phase("hierfavg on the simulator: the 11 gate scenarios")
    check_hierfavg_signatures(dev)
    phase("resume on the card: " + ", ".join(f"{a}/{s}" for a, s in RESUME_RUNS))
    check_resume(dev)
    return counts


TRACING_PHASE = "tracing: the simulator, the plain round and the kernel ops under a Tracer"
ZAMBA2_TRAIN_PHASE = ("LM training path: zamba2-7b, full width, the deepest depth that fits "
                      "(repeats of 13) + 3 tail blocks, bf16, remat")
ZAMBA2_PARITY_PHASE = ("training parity: zamba2-7b, full width, four layers ((mamba2, "
                       "shared_attn) twice), fp32, the card vs the CPU, at (rwkv_chunk, "
                       "ssm_seq_chunk) " + ", ".join(map(str, ZAMBA2_PARITY_SETTINGS)))
# the GQA families' training step held card against CPU: qwen2-moe-a2.7b's
# router and gemma3-12b's local and global layers
TRAIN_PARITY_FAMILIES = ("qwen2-moe-a2.7b", "gemma3-12b", "deepseek-v2-lite-16b",
                         "whisper-small")


def run_lm_families(dev) -> None:
    """``python3 chip_smoke.py --lm-families``: phases 9, 10 and 12 for
    ``LM_FAMILIES`` alone (serving at full width and depth, the two-layer
    parities), without the FedEEC phases."""
    for arch, prefill_len in LM_FAMILIES:
        phase(f"LM serving path: {arch}, full width and depth, bf16")
        drive_lm_path(dev, arch, prefill_len)
    for arch, _ in LM_FAMILIES:
        phase(f"LM parity: {arch}, full width, {two_layer_config(arch).num_layers} layers, "
              "fp32, the card vs the CPU")
        check_lm_parity(dev, arch)
    for arch in TRAIN_PARITY_FAMILIES:
        phase(f"training parity: {arch}, full width, two layers, fp32, the card vs the CPU")
        check_train_parity(dev, arch)


def run_lm_distill_phases(dev) -> None:
    """``python3 chip_smoke.py --lm-distill``: the kernels' checks and times
    at the LM distillation step's shapes, its path at full width, its
    card-vs-CPU parity and the serve_decode example."""
    import torch

    phase("the LM distillation step's kernels vs their plain versions")
    for beta in (0.0, 1.5):
        _distill_case(dev, *DISTILL_TEACHER_SHAPE, torch.float32, beta, False)
    check_skr_rectify(dev)
    phase("the LM distillation step's kernel times")
    time_distill(dev, "lm_distill", *DISTILL_TEACHER_SHAPE, torch.float32, [("t", 1.5)],
                 launches=20)
    time_skr_fused(dev)
    phase(DISTILL_PHASE)
    drive_distill_path(dev)
    phase(DISTILL_PARITY_PHASE)
    check_distill_parity(dev)
    phase(SERVE_DECODE_PHASE)
    drive_serve_decode(dev)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"repro_torch not found under {ROOT / 'src'}")

    dev, name, count, smi = check_device()
    build_kernels()
    phase(ANALYSIS_PHASE)
    run_static_analysis(dev)
    if sys.argv[1:] == ["--analysis"]:
        return
    if sys.argv[1:] in ([], ["--sharding"]):
        phase(DRYRUN_PHASE)
        run_dryrun(dev)
    if sys.argv[1:] == ["--sharding"]:
        phase(MESH_PHASE)
        check_mesh(dev)
        phase(DRYRUN_CARD_PHASE)
        check_dryrun_on_card(dev, measure_serving=True)
        return
    if sys.argv[1:] == ["--rwkv-chunks"]:
        phase("rwkv6_scan_chunked and the backward kernel at each chunk length")
        time_rwkv_chunks(dev)
        time_rwkv_bwd(dev)
        return
    if sys.argv[1:] == ["--baselines"]:
        run_baselines_phases(dev)
        phase("LM checkpoint: train_lm(checkpoint=) on llama3.2-3b reduced to two layers, "
              "bf16, read back")
        check_lm_checkpoint(dev)
        return
    if sys.argv[1:] == ["--tracing"]:
        phase("FedEEC on the simulator: run_experiment('fedeec', FLConfig(), rounds=3, "
              "scenario='mobile_clients')")
        _, res = drive_sim_path(dev)
        phase(TRACING_PHASE)
        run_tracing_phase(dev, res)
        return
    if sys.argv[1:] == ["--rwkv-train"]:
        phase("rwkv6_scan's backward kernel vs the plain backward")
        check_rwkv6_scan_grad(dev)
        phase("LM training path: rwkv6-1.6b, full width and depth, bf16")
        drive_train_path(dev, "rwkv6-1.6b")
        phase("training parity: rwkv6-1.6b, full width, two layers, fp32, the card vs the CPU")
        check_train_parity(dev, "rwkv6-1.6b", RWKV_PARITY_SETTINGS)
        phase("rwkv6_scan's backward kernel at the training shape")
        time_rwkv_bwd(dev)
        return
    if sys.argv[1:] == ["--lm-families"]:
        run_lm_families(dev)
        return
    if sys.argv[1:] == ["--zamba2-train"]:
        phase("distill_loss at zamba2-7b's training loss shape vs its plain version")
        for beta in (0.0, 1.5):
            _distill_case(dev, *ZAMBA2_LOSS_SHAPE, torch.bfloat16, beta, False)
        phase(ZAMBA2_TRAIN_PHASE)
        drive_zamba2_train(dev)
        phase(ZAMBA2_PARITY_PHASE)
        check_train_parity(dev, "zamba2-7b", ZAMBA2_PARITY_SETTINGS)
        phase("distill_loss's CE entry at zamba2-7b's training loss shape: times")
        time_train_loss_kernels(dev)
        return
    if sys.argv[1:] == ["--zamba2-depths"]:
        phase("zamba2-7b training at each depth of " + ", ".join(map(str, ZAMBA2_DEPTHS)))
        measure_zamba2_depths(dev)
        return
    if sys.argv[1:] == ["--latent"]:
        phase("the latent decode kernel vs its plain version, and its times")
        check_latent_decode(dev)
        time_latent_decode(dev)
        phase("LM serving path: deepseek-v2-lite-16b, full width and depth, bf16")
        drive_lm_path(dev, "deepseek-v2-lite-16b", 4096)
        return
    if sys.argv[1:] == ["--c13"]:
        phase("ROADMAP C13: rwkv6-1.6b's two-layer training parity, leaf by leaf")
        diagnose_train_parity(dev)
        return
    if sys.argv[1:] == ["--lm-distill"]:
        run_lm_distill_phases(dev)
        return
    if sys.argv[1:] == ["--distill"]:
        phase("distill_loss: every entry and variant vs the plain versions, and times")
        check_distill_loss(dev)
        check_ce_allocates_no_teacher(dev)
        time_kernels(dev)
        time_train_loss_kernels(dev)
        return

    phase("kernels vs plain versions")
    err = check_distill_loss(dev)
    check_ce_allocates_no_teacher(dev)
    err.update(check_skr_rectify(dev))
    err.update(check_flash_attention(dev))
    err["flash_attention_latent_decode"] = check_latent_decode(dev)
    rwkv_err = check_rwkv6_scan(dev)
    err.update({k: rwkv_err[v] for k, v in RWKV_VARIANTS.items()})
    err["rwkv6_scan_bwd"] = check_rwkv6_scan_grad(dev)
    phase("kernel times")
    times = time_kernels(dev)
    time_skr_queue_pass(dev)

    phase("main path: run_experiment('fedeec', FLConfig(), rounds=3)")
    counts = drive_main_path(dev)

    phase("parity: the card vs the CPU on small inputs")
    check_step_parity(dev)
    check_group_step_parity(dev)
    check_round_parity(dev)

    phase("FedEEC on the simulator: the 11 gate scenarios, then "
          "run_experiment('fedeec', FLConfig(), rounds=3, scenario='mobile_clients')")
    check_sim_signatures(dev)
    sim_counts, sim_res = drive_sim_path(dev)
    for k, n in sim_counts.items():
        counts[k] += n
    phase("serial against coalesced dispatch at FLConfig(): "
          + ", ".join(f"{s} ({r} rounds)" for s, r in DISPATCH_COMPARE))
    held = compare_dispatch(dev)
    for k, n in run_baselines_phases(dev).items():
        counts[k] += n
    # the traced runs' launches stay out of ``counts`` and MAIN_DISTILL /
    # MAIN_SKR, so the kernels line's launch column is the untraced paths'
    phase(TRACING_PHASE)
    run_tracing_phase(dev, sim_res)
    del sim_res

    # each JSON row counts its own CUDA kernel's launches: flash_attention's
    # the tensor-core kernel's at head_dim 128, flash_attention_sm90_64's at
    # 64 (whisper-small's prefill step), flash_attention_sm90_h256's
    # its head_dim 256 instance's (gemma3-12b's prefill step),
    # flash_attention_tf32x3's the 3xTF32 kernel's, flash_attention_decode's the
    # split-KV decode kernel's; rwkv6_scan's the sequential kernel's,
    # rwkv6_scan_chunked's the chunked scan's
    lm_variants = {**VARIANTS, **RWKV_VARIANTS}
    counts.update(dict.fromkeys(lm_variants, 0))
    for arch, prefill_len in LM_ARCHS + LM_FAMILIES:
        phase(f"LM serving path: {arch}, full width and depth, bf16")
        _, variants, _ = drive_lm_path(dev, arch, prefill_len)
        for k, variant in lm_variants.items():
            counts[k] += variants[variant]
    for arch, _ in LM_ARCHS + LM_FAMILIES:
        phase(f"LM parity: {arch}, full width, {two_layer_config(arch).num_layers} layers, "
              "fp32, the card vs the CPU")
        check_lm_parity(dev, arch)
    # the training paths' launches: the loss's distill_loss CE entry, and
    # rwkv6's scans (each forward on the chunked kernel) and their backward
    counts["rwkv6_scan_bwd"] = 0
    for arch, _ in LM_ARCHS:
        phase(f"LM training path: {arch}, full width and depth, bf16")
        train_counts, train_variants, _, _ = drive_train_path(dev, arch)
        for k in ("distill_loss_fwd", "distill_loss_bwd", "rwkv6_scan_bwd"):
            counts[k] += train_counts[k]
        for k, variant in RWKV_VARIANTS.items():
            counts[k] += train_variants[variant]
    phase(MESH_PHASE)
    check_mesh(dev)
    phase(ZAMBA2_TRAIN_PHASE)
    train_counts, _, _ = drive_zamba2_train(dev)
    for k in ("distill_loss_fwd", "distill_loss_bwd"):
        counts[k] += train_counts[k]
    phase(DRYRUN_CARD_PHASE)
    check_dryrun_on_card(dev)
    # the LM distillation path's launches: distill_loss's t entry, SKR's
    # fused entry, the teacher's attention on the (128, 128) instance; the
    # serve_decode example's sequential scans
    phase(DISTILL_PHASE)
    distill_counts, distill_sm90 = drive_distill_path(dev)
    for k in ("distill_loss_fwd", "distill_loss_bwd", "skr_rectify"):
        counts[k] += distill_counts[k]
    counts["flash_attention"] += distill_sm90
    phase(DISTILL_PARITY_PHASE)
    check_distill_parity(dev)
    phase(SERVE_DECODE_PHASE)
    counts["rwkv6_scan"] += drive_serve_decode(dev)
    phase("training parity: llama3.2-3b, full width, two layers, fp32, the card vs the CPU")
    check_train_parity(dev)
    phase("training parity: rwkv6-1.6b, full width, two layers, fp32, the card vs the CPU, "
          "at (rwkv_chunk, ssm_seq_chunk) " + ", ".join(map(str, RWKV_PARITY_SETTINGS)))
    check_train_parity(dev, "rwkv6-1.6b", RWKV_PARITY_SETTINGS)
    phase(ZAMBA2_PARITY_PHASE)
    check_train_parity(dev, "zamba2-7b", ZAMBA2_PARITY_SETTINGS)
    for arch in TRAIN_PARITY_FAMILIES:
        phase(f"training parity: {arch}, full width, two layers, fp32, the card vs the CPU")
        check_train_parity(dev, arch)
    phase("LM checkpoint: train_lm(checkpoint=) on llama3.2-3b reduced to two layers, bf16, "
          "read back")
    check_lm_checkpoint(dev)
    # timed last, so no graph pool or input of the timing is allocated while
    # a main path's peak memory is read
    phase("kernel times at the LM serving and training shapes")
    times.update(time_lm_kernels(dev))
    times.update(time_train_loss_kernels(dev))
    phase("serial against coalesced dispatch: the next round of each under the profiler")
    profile_dispatch(held)
    del held

    # distill_loss's rows are its two entries (the t entry, the CE entry),
    # each launching the kernel its variant rule picks; launches per entry
    # and variant over the main paths' runs
    distill = {}
    for key, n in MAIN_DISTILL.items():
        entry, variant = key.split(":")
        distill.setdefault(DISTILL_ROWS[entry], {})[variant] = n
    for k in ("distill_loss_fwd", "distill_loss_bwd"):
        total = sum(distill[k].values()) + sum(distill[k + "_ce"].values())
        if total != counts[k]:
            fail(f"{k}: {total} launches by entry and variant, {counts[k]} counted")
    for k, by_variant in distill.items():
        counts[k] = sum(by_variant.values())
        if counts[k] <= 0:
            fail(f"{k} was not launched on the main paths")
    print(f"distill_loss launches on the main paths, by entry and variant: {distill}")
    # skr_rectify's rows are its two entries: the fused queue pass + map
    # (the main paths' one launch a teacher step) and the map alone
    skr = {SKR_ROWS[k]: n for k, n in MAIN_SKR.items()}
    if sum(skr.values()) != counts["skr_rectify"]:
        fail(f"skr_rectify: {skr} launches by entry, {counts['skr_rectify']} counted")
    counts.update(skr)
    if counts["skr_rectify"] <= 0:
        fail("skr_rectify's fused entry was not launched on the main paths")
    print(f"skr_rectify launches on the main paths, by entry: {MAIN_SKR}")

    pick = {"distill_loss_fwd": ("main", 1.5), "distill_loss_bwd": ("main", 1.5),
            "distill_loss_fwd_ce": ("main", 0.0), "distill_loss_bwd_ce": ("main", 0.0),
            "skr_rectify": ("main", None), "skr_rectify_map": ("main", None),
            "flash_attention": ("prefill", 0), "flash_attention_tf32x3": ("prefill_fp32", 0),
            "flash_attention_decode": ("decode", 4095),
            "flash_attention_sm90_h256": ("gemma3_global", 0),
            "flash_attention_sm90_192": ("deepseek_prefill", 0),
            "flash_attention_sm90_112": ("zamba2_prefill", 0),
            "flash_attention_sm90_64": ("whisper_self", 0),
            "flash_attention_latent_decode": ("decode", 4095),
            "rwkv6_scan": ("decode", None), "rwkv6_scan_chunked": ("prefill", None),
            "rwkv6_scan_bwd": ("train", None)}
    skr_variant = {row: v for v, row in SKR_ROWS.items()}
    kernels = []
    for k, (tag, beta) in pick.items():
        row = times[(k, tag, beta)]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": TPU_KERNELS[k],
            "launches": counts[k], "max_abs_err": err[k],
            **({"variant": lm_variants[k]} if k in lm_variants else {}),
            **({"variant": skr_variant[k], "variant_launches": MAIN_SKR}
               if k in skr_variant else {}),
            **({"variant_launches": distill[k]} if k in distill else {}), **row,
        })
    print(f"chip_smoke.py: {time.perf_counter() - T0:.1f} s in all")
    print(f"profile_phases windows: {WINDOWS['taken']} taken, {WINDOWS['retaken']} of them "
          "taken again after the profiler lost records inside them (ROADMAP C14)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
