#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py          # from the root of a checkout

1. Device and build: prints the card (nvidia-smi's name and power
   limit), builds the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   each, all at once) and prints their build time and ptxas lines.
2. Kernels: holds each CUDA kernel against its plain PyTorch version on
   the card, at T ∈ {4, 128, 2048} rows and the linears of smollm-360m
   (Llama-2-7B's for the standalone reflections, WIDE_LINEARS), n ∈ {8,
   32} blocks, bf16 and float32, and times the
   kernel, its plain version and ``torch.matmul`` on the same product
   (CUDA events, warmed up, weights rotated past the 50 MB L2); each
   ``householder_gemm`` row prints the route it took (``wgmma``,
   ``wgmma_decode`` or ``simt``), and the host cost of a decode step's
   calls (µs a call through ``ops.householder_gemm`` and
   ``execute.dispatch``, HOST_CALLS calls each, cycling through the
   step's adapted linears; ``host_cost``) is printed.  The
   ETHER+ kernels (``etherplus_gemm`` one- and two-sided, the left and
   right ``etherplus_merge`` kernels) run on adapters whose v is drawn
   apart from u, from their own generator, so the ETHER rows see the
   inputs they always did; each bf16 ``etherplus_gemm`` row and each bf16
   ``householder_gemm_batched`` row prints its route and epilogue and the
   ms of each route forced on its launcher (the rows that decided their
   route rules).
3. Serve: smollm-360m at full width (32 layers, bf16, random weights from
   a seed) with ETHER n_blocks=8, B=4, P=32, 16 new tokens, through the
   CLI's ``serve`` entry point, unmerged and then merged; asserts that
   every adapted linear ran the CUDA kernels, every layer's attention of
   every prefill and decode step the flash kernel (``flash_attention.cuda``;
   so do phases 5, 7, 9, 11 and 12), and nothing ran the plain versions,
   every prefill's ``householder_gemm`` on the ``wgmma`` route and every
   decode step's on ``wgmma_decode`` (``ops.routes()``; phases 15 and 17
   likewise, phase 4's train steps all on ``wgmma``), every prefill's
   attention on the flash kernel's ``wgmma`` route and every decode
   step's on ``decode`` (``ops.routes("flash_attention")``; phases 5, 7,
   9, 11, 12 and 17 likewise), no flash tensor map looked up in a decode
   step,
   holds merged against unmerged and the kernels' path against
   the plain path, and prints prefill ms, decode ms per token and peak
   memory.
4. Train: smollm-360m at full width (32 layers, bf16, remat "full",
   random weights from a seed) with ETHER n_blocks=32 on all seven
   linears, B=8, S=128, AdamW lr 2e-3 with a cosine schedule and warmup
   2, through the port's ``Trainer``: TRAIN_STEPS steps on the kernels'
   path (counted: every adapted linear's forward, remat recompute and
   backward on the CUDA kernels, nothing on the plain versions), the
   same steps on the plain path on the card (per-step losses and
   gradient norms, read from each Trainer's JSONL log, and the adapter
   updates held to TRAIN_TOL), and a restore from the step-TRAIN_CKPT checkpoint
   run to the end again, bitwise equal to the uninterrupted run under
   ``torch.use_deterministic_algorithms(True)``.  Prints step ms,
   tokens/s, peak memory and, from a torch.profiler trace of the step,
   the device's busy time, the dXr backward's kernels and the host's
   top-level ops; every bf16 ``reflect_gemm_dx`` launch on the ``wgmma``
   route (``ops.routes("reflect_gemm_dx")``; phase 6 likewise, and phase
   14's ``householder_gemm_batched_bwd``).
5. Serve ETHER+: phase 3's model and requests with two-sided ETHER+
   (n_blocks 8), its v1/v2 drawn apart from u1/u2 from a seed (the
   method's init has H⁺ = I), through ``serve.generate`` unmerged and
   after ``merge_params``; the same checks, counts and trace as phase 3,
   and every ``etherplus_gemm`` launch on the route its rule gives
   (``ops.routes("etherplus_gemm")``).
6. Train ETHER+: phase 4 with two-sided ETHER+ (n_blocks 32), from the
   method's own init, through ``Trainer``; the same checks, with the
   ETHER+ backward's counts (the y0 recompute and
   ``etherplus_reflect_bwd`` in every adapted linear's backward), every
   bf16 ``etherplus_gemm`` launch (forward, remat, y0 recompute) on
   ``wgmma``, and the two forwards' device ms a step in the trace.
7. Serve DeLoRA: phase 3's model and requests with DeLoRA at rank 8 on
   all seven linears, its b and λ moved off the method's init (b = 0 is
   ΔW = 0) from a seed, through ``serve.generate`` unmerged
   (``delora_gemm``) and after ``merge_params`` (``delora_merge``):
   counts, merged vs unmerged and kernels vs plain path, and the adapters
   must move the logits by more than the tolerance; then the decode
   step's trace, as phase 3.
8. Train DeLoRA: phase 4 with DeLoRA (rank 8) from the method's own init
   (b = 0, so s starts at λ/(r·ε)), through ``Trainer``: the forward, its
   remat recompute and the dx of every backward on ``delora_gemm``, no
   ``reflect_gemm_dw``; the same checks as phase 4, but the adapter
   update is held to its limit on a second pair of runs (kernels, plain)
   from b ≠ 0: from b = 0 its first step is a sign pattern that rounding
   decides (see phase_train).
9. Serve HyperAdapt: phase 7 with HyperAdapt, its r and c drawn about 1
   (``hyperadapt_gemm``, ``hyperadapt_merge``).
10. Train HyperAdapt: phase 8 with HyperAdapt from its init (r = c = 1):
   the forward, remat, and the backward's z and y0 on ``hyperadapt_gemm``.
11. The plain-PyTorch methods at full width on the card: LoRA, OFT and
   Naive (adapters moved off their init from a seed) serve unmerged and
   merged, ``full`` unmerged; each trains 2 steps from its init through
   ``launch/steps`` with a finite loss; nothing dispatches to a kernel.
   Prints step ms and peak memory (full finetuning's above all).
12. Serve banks: for ETHER, ETHER+, DeLoRA and HyperAdapt, phase 3's model
   and requests served from a bank of BANK_TENANTS = 64 tenants (each
   from its own seed, moved off its method's identity as phases 5, 7 and
   9 move theirs) through ``serve.generate``'s bank path, ids BANK_IDS
   (two tenants, one twice, A − 1), then tenant 0 merged (the
   ``--tenants`` mode's baseline): counts (every adapted linear on its
   bank kernel, twice for two-sided ETHER+; no plain call), bank vs the
   plain path and each row vs single-tenant serving of its tenant on the
   kernels, held to SERVE_TOL (the ETHER bank's ``householder_gemm_batched``
   launches on the route their rule gives), and every row moved by more
   than SERVE_TOL
   when served by another tenant; prints bank vs merged prefill and
   decode times, the bank's bytes, peak memory and the bank's decode-step
   trace, and, for DeLoRA, the cost of its scale over the whole bank.
13. Train in weight mode (``--peft-mode weight``: y = x·merge(W)): phase
   4's model, batch and optimizer for ETHER and two-sided ETHER+ (v
   drawn apart from u; TRAIN_STEPS steps, checkpoint at TRAIN_CKPT) and
   DeLoRA (from b ≠ 0)
   and HyperAdapt (off r = c = 1), 4 steps each (WEIGHT_STEPS), through
   ``Trainer``: counted (each linear's merge kernel twice a step, forward
   and remat recompute; its backward once: ``merge_left_bwd`` for ETHER,
   ``etherplus_merge_left`` (H⁺W again), ``merge_right_bwd`` and
   ``merge_left_bwd`` for ETHER+; no plain call, no ``householder_gemm``),
   kernels vs plain path to TRAIN_TOL, the restore bitwise, the step's
   trace; each step printed beside the method's activation-mode step.
   Then ETHER and ETHER+ in blockgemm mode (dense blocks, plain PyTorch)
   for BLOCKGEMM_STEPS steps, their losses held to weight mode's.
14. Train through a bank: phase 4's model, batch and optimizer with a
   bank of BANK_TENANTS tenants of ETHER, two-sided ETHER+, DeLoRA (from
   b ≠ 0) and HyperAdapt (each tenant off its identity, as in phase 12),
   ids BANK_TRAIN_IDS, TRAIN_STEPS steps of ``train_loss(params,
   bank.request(ids), ...)`` with AdamW on the bank's tree
   (``launch/steps.make_bank_train_step``): counted (every adapted
   linear's forward and remat recompute on its bank kernel, its backward
   on ``householder_gemm_batched_bwd`` / ``etherplus_reflect_batched_bwd``
   or on the bank forward kernels for DeLoRA and HyperAdapt; no plain
   call, 0 ``householder_gemm_batched_dw``), kernels vs plain path to
   TRAIN_TOL, the tenants no id names unmoved with exactly zero gradient
   rows, a restore from the step-TRAIN_CKPT checkpoint of the bank's
   state bitwise equal, every bf16 ``householder_gemm_batched`` launch on
   ``wgmma``, the step's trace (with the two forwards' device ms); each
   step printed beside the method's single-tenant activation step.
15. Serve Mamba-2: mamba2-1.3b ``full()`` (48 layers, d_model 2048, 64
   heads of 64, state 128, chunk 256, bf16, random weights from a seed)
   with ETHER n_blocks 8 on in_proj and out_proj, B = 4 at P = 600 (three
   chunks, the last padded) and at P = 32 (one short chunk), 16 new
   tokens, through ``serve.generate`` unmerged and merged: counted (every
   prefill layer's scan on the SSD kernel ``ssd_chunk`` as
   ``ssd_chunked.cuda``, the adapted linears on ``householder_gemm`` or
   merged by ``ether_merge``, no plain call), merged vs unmerged and the
   kernels' path vs the plain path to MAMBA_TOL in bf16 with the adapters
   moving the logits by more, and the same model in float32 to
   MAMBA_TOL's f32 limit, a right-padded batch with true lengths against
   each row's unpadded prompt (logits, next token, state); prints prefill
   ms, decode ms per token, peak memory and, from traces of a prefill and
   of the decode step, the device's idle share.
16. The registry: each of the fourteen forward ops that have an autograd
   Function (``execute.FUNCTIONS``: the two standalone reflections
   ``ether_reflect`` and ``ether_reflect_batched``, and the twelve GEMM,
   merge and bank ops of phases 3-14) dispatched through
   ``execute.dispatch(op, "cuda", ...)`` under autograd at one
   smollm-360m train layer's gate_proj (B·S = 8·128, 960×2560, 32 blocks,
   a 64-tenant bank, ids BANK_TRAIN_IDS), bf16 and f32, x and the
   adapters requiring grad, a scalar loss and ``backward()``: counted
   (``<op>.cuda`` and ``<op>_bwd.cuda`` once each, no plain call), the
   output and every gradient against the ``torch`` route on the card;
   ``ssd_chunked`` under grad on ``cuda`` raises NotPortedError.
17. Serve qwen2.5-32b: ``full()`` at full width (d_model 5120, 40 query
   heads over 8 KV heads of 128, d_ff 27648, QKV bias, rope θ 1e6, the
   untied 152,064-entry head, bf16), depth cut to QWEN_LAYERS = 8 of 64
   (memory: see QWEN_LAYERS), random weights from a seed, ETHER n_blocks
   8 on all seven linears, B = 2 at P = 2048, 16 new tokens, through
   ``serve.generate`` unmerged and merged: counted (every layer's prefill
   and decode attention on ``flash_attention.cuda``, every adapted linear
   on ``householder_gemm`` or merged by ``ether_merge``, no plain call),
   merged vs unmerged and kernels vs plain path to SERVE_TOL with the
   adapters moving the logits by more, the logits against
   ``torch.matmul`` of the final hidden state by the untied head; prints
   prefill ms, decode ms per token, peak memory and, from traces of a
   prefill and a decode step, the device's idle share.  Training never
   reaches the flash kernel (it has no backward): the train phases
   count every layer's attention and its remat recompute as
   ``flash_attention.torch``, the plain route under autograd.

Phase 2 also holds ``reflect_gemm_dx`` (dx and du) and ``reflect_gemm_dw``
against their plain versions at T ∈ {1024, 2048} (and a ragged 1000),
rank 1 and, with ETHER+'s v, rank 2, and ``etherplus_reflect_bwd`` on the
output side, and times them beside ``torch.matmul`` of the GEMM inside
each; each ``reflect_gemm_dx`` and ``householder_gemm_batched_bwd`` row
records its route (``wgmma`` or ``simt``, the route rule's) and the wgmma
route's epilogue (``fused`` or ``scratch``), and both are also held and
timed, bf16, at Llama-2-7B's linears with T = 4,096 (see wide_bwd_rows).
For DeLoRA and HyperAdapt it holds ``delora_gemm`` (r ∈ {8, 64}) and
``hyperadapt_gemm`` at the forward rows, ``delora_merge`` and
``hyperadapt_merge`` on the weights, and the backward compositions
``delora_gemm_bwd`` and ``hyperadapt_gemm_bwd`` at the backward rows, on
operands off the methods' identity init, to METHOD_TOL; ``delora_merge``
is also timed beside ``torch.addmm(w, a·s, b)``, the one PyTorch call
that computes it.  The four bank kernels (``householder_gemm_batched``,
``etherplus_reflect_batched``, ``delora_gemm_batched``,
``hyperadapt_gemm_batched``) are held to TOL at smollm-360m's linears
with a 64-tenant bank at BANK_ROWS, bf16 and f32 (see bank_kernel_rows).
The two merge backward kernels (``merge_left_bwd`` at rank 1 and 2, with
and without dW, and ``merge_right_bwd``) are held to TOL (du, dv to
DU_TOL) on phase 2's linears, n ∈ {8, 32}, bf16 and f32, including the
left kernel's branch for strips past shared memory (see merge_bwd_rows).
The bank backward kernels (``householder_gemm_batched_bwd`` with its
per-sequence ĝ, ``householder_gemm_batched_dw``,
``etherplus_reflect_batched_bwd``) and DeLoRA's and HyperAdapt's bank
backward compositions are held at smollm-360m's linears with a 64-tenant
bank at BANK_BWD_ROWS (decode, the train step's 8 × 128, a ragged S =
100), n ∈ {8, 32}, bf16 and f32 (see bank_bwd_rows).  The SSD kernel
``ssd_chunk`` is held to TOL against its plain version at mamba2-1.3b's
scan (B·H = 4·64, P = 64, N = 128, chunk 256, b and c in bf16) at S ∈ {32,
600 padded to 768, 2048} and timed beside it (see ssd_kernel_rows);
``householder_gemm`` and ``ether_merge`` are also timed at mamba2-1.3b's
in_proj (2048×8512) and out_proj (4096×2048).  The standalone reflections
``ether_reflect``, ``ether_reflect_bwd``, ``ether_reflect_batched`` and
``ether_reflect_batched_bwd`` are held to TOL (du to DU_TOL) at
smollm-360m's input widths (T ∈ REFLECT_ROWS, n ∈ {8, 32}), Llama-2-7B's
(db up to 1,376) and a 64-tenant bank at BANK_BWD_ROWS, bf16 and f32 (see
reflect_kernel_rows).  The flash kernel ``flash_attention`` is held to
FLASH_TOL against its plain version at FLASH_ROWS (qwen2.5-32b's prefill
layer, a ragged S = T = 2000 under a window, a cached-prefix chunk, two
decode steps, rows with no valid key: exact zeros, a row for each of its
routes and a KV head beside one filled with inf), bf16 and f32, each
row's route printed, and timed beside its plain version and
``scaled_dot_product_attention`` (see flash_kernel_rows).

Float32 matmuls run in full f32 (TF32 off) throughout, as the kernels
compute; ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts so that
cuBLAS is deterministic in the train phases.

Any failure raises and exits non-zero; the last line is the device JSON
object, the line before it the kernels' JSON line.  Full tables go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (NVIDIA), dense rates, at the 700 W power limit
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}   # f32: no tensor cores
# normalised max error max|kernel − plain| / max|plain|: float32 sums of up
# to 11008 terms in another order; bf16 one output rounding (2^-8) apart
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# merged vs unmerged, and kernels vs plain path, after 32 bf16 layers:
# relative Frobenius norm of the last-position logits.  The merged weights
# are rounded to bf16 once more; with the plain versions on the CPU the
# two differ by 2.4e-2 at this config (seed 0), so 5e-2 keeps a 2x margin
SERVE_TOL = 5e-2
LINEARS = {"smollm-360m": [(960, 960), (960, 320), (960, 2560), (2560, 960)]}
# Llama-2-7B's linears, swept by the standalone reflections' rows alone
# (db up to 1,376).  The kernels that the path phases hold at
# smollm-360m's widths lost their Llama-2-7B rows when the script's
# phases passed 1,050 s of its 1,200 s (1,150.1 s on the H100 of one run;
# PERF.md)
WIDE_LINEARS = {"llama-2-7b": [(4096, 4096), (4096, 11008), (11008, 4096)]}
# one smollm-360m layer: q, o (960²), k, v (960×320), gate, up, down
LAYER = {(960, 960): 2, (960, 320): 2, (960, 2560): 2, (2560, 960): 1}
ROWS = (4, 128, 2048)
BLOCKS = (8, 32)
ARCH, B, P, GEN, N_BLOCKS = "smollm-360m", 4, 32, 16, 8
# decode steps traced under torch.profiler (phases 3, 5, 7, 9, 12): the
# trace reports means a step, and its post-processing in Python grows with
# the steps traced (the script's serve phases took 64-76 s each with 16)
TRACE_STEPS = 4
# backward kernels: the train step's B·S = 8·128 rows, a longer 2048, and
# a ragged 1000 at smollm-360m's linears with n = 32 (db = 30 and 80)
BWD_ROWS = (1024, 2048)
BWD_RAGGED = 1000
# du: relative Frobenius, the same f32 math in another sum order
DU_TOL = 1e-4
# phase 2's dXr backwards at Llama-2-7B's linears (WIDE_LINEARS), bf16,
# n = TRAIN_BLOCKS: T = B·S rows, the bank's as B sequences of S.  d = 4096
# fuses the reflection backward into the GEMM (db 128), d = 11008 takes the
# scratch epilogue (db 344)
WIDE_BWD_BANK = (32, 128)
# the dXr backwards' kernels in a trace: the wgmma route's GEMM, the ĝ
# sums (du_kernel is etherplus_reflect_bwd's too) and the SIMT route's or
# scratch epilogue's reflection backward
DXR_KERNELS = ("dxr::", "du_kernel", "seq_ghat_kernel", "bank_chain_kernel",
               "reflect_bwd_kernel")
TRAIN_B, TRAIN_S, TRAIN_BLOCKS, TRAIN_STEPS, TRAIN_CKPT = 8, 128, 32, 8, 4
TRAIN_LR, TRAIN_WARMUP = 2e-3, 2
# phase 2's standalone reflections (the registry's ether_reflect and its
# backward): smollm-360m's decode rows, its train rows and a ragged T
REFLECT_ROWS = (B, TRAIN_B * TRAIN_S, BWD_RAGGED)
# phase 16, the registry: the fourteen forward ops at one smollm-360m train
# layer's gate_proj (d 960, f 2560), B·S = TRAIN_B·TRAIN_S rows
REGISTRY_LINEAR = (960, 2560)
# kernels' path vs plain path after TRAIN_STEPS bf16 steps: per-step
# relative difference of the loss and of the gradient's global norm, and
# relative Frobenius of the adapters' total update (final − initial).
# Both paths compute the same f32 math and round dx to bf16 once; the
# sums' order differs and a bf16 rounding of dx can flip.  The loss moves
# 2.2e-3 relative over the 8 steps, and the paths differed by 2.63e-5
# (PERF.md), so 1e-4 catches adapters that do not move.  grad_norm is not
# scale-free as Adam's update is, so it catches a du off by a factor:
# 1.13e-3 measured, limit 5e-3.  The update carries bf16 flips through
# Adam's sign-like first steps into small-gradient elements: 3.48e-2
# measured, limit 5e-2
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 5e-3, "update": 5e-2}
# ETHER+ serving (phase 5): how far v1/v2 are drawn from u1/u2, relative
# to their (unit-variance) entries
EP_SPREAD = 0.5
# DeLoRA and HyperAdapt rows of phase 2: normalised max error against the
# plain version, over every output of a row (the ETHER+ kernels measured
# f32 ≤ 5.3e-6 over the same sweep, PERF.md); DeLoRA's ranks
METHOD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
METHOD_RANKS = (8, 64)
# phases 7-10: rank 8 on all seven linears (alpha = rank, as the train
# CLI sets it); phases 7 and 9 move the adapters off the method's init:
# DeLoRA's b (its scale normalises away, so only the direction counts)
# and λ (to about 2, λ/r = 0.25 per normalised component), HyperAdapt's
# r and c to 1 + HA_SPREAD·N(0, 1)
METHOD_RANK, DELORA_LAM, DELORA_LAM_SPREAD, HA_SPREAD = 8, 2.0, 0.5, 0.1
# phase 8 also trains DeLoRA from b = DELORA_B0·N(0, 1), where its update
# does not start as a sign pattern (see phase_train)
DELORA_B0 = 0.05
# phase 11: the plain-PyTorch methods' adapters moved off their init by
# this much: LoRA's b, OFT's R, Naive's m − I
BASELINE_SPREAD = {"lora": 0.05, "oft": 0.01, "naive": 0.01}
BASELINE_GEN, BASELINE_STEPS = 4, 2
# multi-tenant banks (phase 2's bank rows, phase 12): A tenants, and the
# ids of each group of four sequences: two different tenants, one twice,
# the last row A − 1
BANK_TENANTS = 64
BANK_IDS = [5, 17, 5, BANK_TENANTS - 1]
# phase 2's bank rows: (B, S) of decode, prefill, a long prefill and a
# ragged S
BANK_ROWS = ((4, 1), (4, 32), (16, 128), (4, 33))
# and householder_gemm_batched's wide decode row: B = A sequences of one
# token, every tenant once (its wgmma route reads W once a sequence, from
# L2 at these widths, where simt reads it once a batch)
BANK_WIDE_DECODE = (BANK_TENANTS, 1)
# phase 2's bank backward rows: (B, S) of decode, the train step and a
# ragged S (32-row tiles never straddle two sequences), at n ∈ BLOCKS
BANK_BWD_ROWS = ((4, 1), (TRAIN_B, TRAIN_S), (4, 100))
# phase 14, training through a bank: the ids of the B = 8 sequences (two
# tenants twice, A − 1; 58 of the 64 tenants serve no sequence).  Phase
# 4's steps, schedule and checkpoint: over 3 steps at full lr from the
# first (no warmup) Adam's update is a sign pattern, and the elements of
# the bank's gradient at bf16-rounding level took either sign on either
# path: on the H100 the update parted by 1.157e-01 where the losses
# agreed to 4.8e-5 and the grad norms to 3.0e-4 (PERF.md, run AB); over
# phase 4's 8 steps every single-tenant run agreed to 3.4-3.6e-2
BANK_TRAIN_IDS = [5, 17, 5, BANK_TENANTS - 1, 40, 2, 17, 29]
# phase 13, weight mode: (steps, checkpoint step) per method, None for
# TRAIN_STEPS and TRAIN_CKPT; DeLoRA and
# HyperAdapt take fewer steps (their merges have no backward kernel of
# their own: dW' runs through thin glue and the merge kernel)
WEIGHT_STEPS = {"ether": (None, None), "etherplus": (None, None),
                "delora": (4, 2), "hyperadapt": (4, 2)}
# blockgemm mode (plain PyTorch): its first steps' losses (the third
# after the first update: the warmup's first lr is 0) against weight
# mode's, per-step relative difference.  The dense blocks are rounded to
# bf16 before n block GEMMs in bf16, where the merge kernel computes in
# f32 and rounds W' once: W' differs by a rounding or two (2^-8) per
# element, which moved the losses by 6.5e-5 (ETHER) and 1.3e-4 (ETHER+)
# on the H100 (PERF.md); 2e-3 catches a wrong block or side
BLOCKGEMM_STEPS, BLOCKGEMM_TOL = 3, 2e-3
# phase 15: mamba2-1.3b full() (48 layers, d_model 2048, 64 heads of 64,
# state 128, chunk 256), ETHER n_blocks 8 on in_proj/out_proj, B = 4 at
# P = 600 (three chunks, the last padded) and P = 32 (one short chunk),
# GEN new tokens; a padded batch's true lengths (each row's next token
# against its unpadded prompt's)
MAMBA_ARCH, MAMBA_PROMPTS, MAMBA_TRUE_LENS = ("mamba2-1.3b", (600, 32),
                                               [600, 437, 32, 1])
# phase 15's logits, relative Frobenius.  float32: the same model in f32,
# kernels vs plain path and merged vs unmerged, sums in another order
# (the smoke model's CPU tests hold 3e-5).  bf16: two paths whose bf16
# roundings fall at different places part further through 48 recurrent
# layers than through smollm-360m's 32: merged vs unmerged 6.58e-2, the
# kernels vs the plain path 4.75e-2 (PERF.md, run AF), and 6.53e-2 and
# 4.66e-2 on the second of MAMBA_SEEDS (run AJ); 1e-1 stays 10x
# below the adapters' own effect on the logits (1.02), which is checked
MAMBA_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
# phase 15 builds its model from the first seed and holds the bf16 paths
# again on a model from the second
MAMBA_SEEDS = (0, 10)
# a right-padded row against its unpadded prompt: the SSM state bitwise
# equal, the logits to this relative Frobenius norm (measured 9.8e-8 to
# 1.0e-7, PERF.md), the next token equal
MAMBA_PAD_TOL = 1e-6
# phase 2's SSD rows: mamba2-1.3b's scan at B·H = 4·64, P = 64, N = 128,
# one group, chunk 256, b and c in bf16 (the model's), at S = 32, 600
# (padded to 768, as ssd_chunked pads) and 2048
SSD_SHAPE, SSD_SEQS = dict(b=4, h=64, p=64, g=1, n=128, chunk=256), (32, 600,
                                                                    2048)
# phase 2 also times householder_gemm and ether_merge at mamba2-1.3b's
# adapted linears, in_proj 2048×8512 and out_proj 4096×2048
SSM_LINEARS = {"mamba2-1.3b": [(2048, 8512), (4096, 2048)]}
# and at phase 17's: qwen2.5-32b's q/o (5120²), k/v (5120×1024),
# gate/up (5120×27648) and down (27648×5120) linears, n = N_BLOCKS (db
# 640 and 3,456), at the rows of its decode step and its prefill (see
# QWEN_B and QWEN_P below)
QWEN_LINEARS = {"qwen2.5-32b": [(5120, 5120), (5120, 1024), (5120, 27648),
                                (27648, 5120)]}
# phase 2's flash rows: (name, B, H, Hkv, S, T, D, q_offset, window), all
# causal: qwen2.5-32b's prefill layer (phase 17's main path), a ragged
# prompt under a window, a cached-prefix chunk, smollm-360m's prefill
# (phases 3-12) and decode steps, qwen2.5-32b's decode step, and rows
# that see no key (window 16 past the last key); then a row for each
# route of flash_attention.route (bf16 takes `wgmma` where a KV group
# brings more than 64 rows at D 64 or 128, `decode` at most 64 rows in
# either dtype, `simt` the rest): a ragged D = 64 prefill (`wgmma` in
# bf16), four query rows a head under a window over a long cache
# (`decode`, 16 splits), a D = 32 prefill (`simt`); and POISONED_ROW,
# whose KV head 1 is filled with inf: KV head 0's query heads, held to
# the plain version, must not read it at their ragged T = 200 edge
FLASH_ROWS = (("qwen2.5-32b prefill", 2, 40, 8, 2048, 2048, 128, 0, None),
              ("ragged, window 1024", 2, 40, 8, 2000, 2000, 128, 0, 1024),
              ("cached-prefix chunk", 2, 40, 8, 128, 2048, 128, 1920, None),
              ("smollm-360m prefill", 4, 15, 5, 32, 32, 64, 0, None),
              ("smollm-360m decode", 4, 15, 5, 1, 48, 64, 47, None),
              ("qwen2.5-32b decode", 2, 40, 8, 1, 2064, 128, 2048, None),
              ("fully masked rows", 1, 4, 2, 256, 128, 64, 136, 16),
              ("ragged D=64 prefill", 2, 15, 5, 1000, 1000, 64, 0, None),
              ("4 rows, window 1024", 2, 16, 4, 4, 4096, 128, 4000, 1024),
              ("D=32 prefill", 2, 8, 2, 512, 512, 32, 0, None),
              ("poisoned neighbour", 1, 8, 2, 200, 200, 128, 0, None))
POISONED_ROW = "poisoned neighbour"
# f32: normalised max error (the same f32 math, sums over up to 2048 keys
# in another order); bf16: relative Frobenius norm, one rounding of an
# f32 result on each side
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the host cost of a decode step's householder_gemm calls: smollm-360m's
# adapted linears in a step's order, B rows, bf16, n = N_BLOCKS (see
# host_cost); at least HOST_CALLS calls through the wrapper and as many
# through execute.dispatch, in whole steps, host clock
# (tools/host_cost.py runs the same measurement on two trees in turns)
HOST_CALLS = 5000
# phase 17: qwen2.5-32b full() at full width, depth cut to QWEN_LAYERS of
# its 64 layers (8 layers are 7.8 GB of bf16 weights beside the 3.1 GB
# embedding and untied head; merge_params adds a second 7.8 GB; 64 would
# be 65.5 GB before the merged copy), ETHER n_blocks 8 on all seven
# linears, B = QWEN_B at P = QWEN_P (a long-document prompt), GEN new
# tokens
QWEN_ARCH, QWEN_LAYERS, QWEN_B, QWEN_P = "qwen2.5-32b", 8, 2, 2048
# phase 17's logits against torch.matmul of the final hidden state by the
# untied head: the same product on the same hidden state, in float32
QWEN_HEAD_TOL = 1e-6


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def timed_ms(torch, fns) -> float:
    """Mean ms per call over a rotation of closures (each on its own copy
    of the operands), warmed up, timed with CUDA events."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fns[0]()
    end.record()
    torch.cuda.synchronize()
    reps = max(len(fns), min(200, int(30.0 / max(start.elapsed_time(end),
                                                 1e-3))))
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want, dtype: str, what: str = "kernel"):
    """(max abs error, normalised max error) of a kernel's result against
    its plain version's; fails beyond TOL[dtype]."""
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    check(rel <= TOL[dtype], f"{what} disagrees with its plain version: "
          f"{rel:.3e} > {TOL[dtype]:g}")
    return err, rel


def routed(ops, op: str = "householder_gemm") -> str:
    """The routes ``op``'s launches took since the last reset."""
    return ",".join(k.split(".", 1)[1] for k, v in ops.routes(op).items()
                    if v) or "none"


@contextlib.contextmanager
def forced_route(module, name, on):
    """Every call that consults the route rule ``module.name`` takes route
    ``on`` while the block runs."""
    rule = getattr(module, name)
    setattr(module, name, lambda *a, **k: on)
    try:
        yield
    finally:
        setattr(module, name, rule)


def served_routes(ops, per_forward, forwards, prefill_rows, decode_rows):
    """householder_gemm's launches by route in a served bf16 run
    (``serve.generate``: two prefills of ``prefill_rows`` rows, then
    ``forwards`` − 2 decode steps of ``decode_rows``), ``per_forward``
    adapted linears a forward, every width a multiple of 8: at most
    DECODE_ROWS rows on ``wgmma_decode``, more on ``wgmma``, none on
    ``simt``."""
    from repro_torch.kernels import householder_gemm as hh
    want = dict.fromkeys(ops.routes(), 0)
    for rows, calls in ((prefill_rows, 2), (decode_rows, forwards - 2)):
        name = "wgmma_decode" if rows <= hh.DECODE_ROWS else "wgmma"
        want[f"householder_gemm.{name}"] += calls * per_forward
    return want


def served_fwd_routes(ops, op, rule, per_forward, forwards, prefill_rows,
                      decode_rows):
    """``op``'s launches by route (``etherplus_gemm`` or
    ``householder_gemm_batched``) in a served bf16 run of ``forwards``
    forwards as :func:`served_routes` counts them, ``rule(rows)`` the route
    of a call on ``rows`` rows (for the bank, rows a sequence)."""
    want = dict.fromkeys(ops.routes(op), 0)
    for rows, calls in ((prefill_rows, 2), (decode_rows, forwards - 2)):
        want[f"{op}.{rule(rows)}"] += calls * per_forward
    return want


def check_fwd_routes(routes, want, op, what):
    print(f"[{what}] {op} routes: {routes}")
    check(routes == want, f"{what}: {op} launched on routes {routes}, want "
          f"{want}")


def check_routes(r, want, what):
    print(f"[{what}] householder_gemm routes: {r['routes']}")
    check(r["routes"] == want, f"{what}: householder_gemm launched on "
          f"routes {r['routes']}, want {want}")


def check_dx_route(ops, op, dt, d, f, n):
    """The route of the one ``op`` (``reflect_gemm_dx`` or
    ``householder_gemm_batched_bwd``) launch since the last reset, which
    must be the route rule's for these aligned operands of dtype ``dt``."""
    from repro_torch.kernels import reflect_gemm_dx as kdx
    got = routed(ops, op)
    want = kdx.route(dt, 0, d, f, n, d // n, True)
    check(got == want, f"{op} at {dt} d={d} f={f} n={n} launched on route "
          f"{got}, want {want}")
    return got


def dx_epilogue(route, n, d):
    """The wgmma route's epilogue at n blocks of d / n (``fused`` or
    ``scratch``); the SIMT route's is the scratch one."""
    from repro_torch.kernels import reflect_gemm_dx as kdx
    return kdx.epilogue(n, d // n) if route == "wgmma" else "scratch"


def check_dx_routes(routes, launches, op, what):
    """A bf16 train path's ``op`` launches (every shape of it aligned, d
    and f multiples of 8), all on the ``wgmma`` route; printed."""
    print(f"[{what}] {op} routes: {routes}")
    check(routes == {**dict.fromkeys(routes, 0),
                     f"{op}.wgmma": launches[op]},
          f"{what}: {op} launched on routes {routes}, want all "
          f"{launches[op]} on wgmma")


def launched(result):
    """A launcher's outputs after its cudaError_t, which must be 0."""
    check(result[0] == 0, f"launch refused (cudaError_t {result[0]})")
    return result[1:] if len(result) > 2 else result[1]


def bound(nbytes: float, flops, dtype: str = "") -> tuple[float, str]:
    """The least time (ms) for ``nbytes`` of memory traffic and ``flops``
    at ``dtype``'s peak, or for ``flops`` given as {dtype: count}, whose
    times add; and which of the two bounds it."""
    by_type = flops if isinstance(flops, dict) else {dtype: flops}
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(f / PEAK_FLOP_S[d] for d, f in by_type.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_device_and_build(torch, build):
    print("== phase 1: device and build", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    log = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(f'csrc/{n}.cu' for n in build.SOURCES)}")
    for name in build.SOURCES:
        entry = log.get(name)
        if entry is None:
            print(f"  {name}: already built in {build.BUILD_DIR}")
            continue
        print(f"  {name}: nvcc {entry['seconds']:.2f} s")
        for line in entry["ptxas"]:
            print(f"    {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_kernels(torch, ops, ref):
    print("== phase 2: kernels against their plain versions", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def copies(nbytes):
        return max(1, min(256, int(100e6 // max(nbytes, 1)) + 1))

    # arch: (its adapted linears (d, f), n_blocks, rows T)
    sweep = {**{arch: (shapes, BLOCKS, ROWS) for arch, shapes in
                {**LINEARS, **SSM_LINEARS}.items()},
             **{arch: (shapes, (N_BLOCKS,), (QWEN_B, QWEN_B * QWEN_P))
                for arch, shapes in QWEN_LINEARS.items()}}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for arch, (shapes, blocks, ts) in sweep.items():
            for d, f in shapes:
                w0 = torch.randn(d, f, generator=gen, device="cuda") / d ** .5
                ws = [w0.to(dt).clone() for _ in range(copies(d * f * es))]
                del w0
                for n in blocks:
                    db = d // n
                    u = torch.randn(n, db, generator=gen, device="cuda")
                    err, rel = compare(ops.ether_merge(ws[0], u),
                                       ref.ref_ether_merge(ws[0], u), dtype)
                    b_ms, b_by = bound(2 * d * f * es + 4 * d,
                                       4 * d * f + 3 * d, dtype)
                    rows.append(dict(
                        kernel="ether_merge", arch=arch, dtype=dtype, t=None,
                        d=d, f=f, n=n, max_abs_err=err, rel_err=rel,
                        tol=TOL[dtype],
                        ms=timed_ms(torch, [lambda w=w: ops.ether_merge(w, u)
                                            for w in ws]),
                        plain_ms=timed_ms(torch, [
                            lambda w=w: ref.ref_ether_merge(w, u)
                            for w in ws]),
                        matmul_ms=None, bound_ms=b_ms, bound_by=b_by))
                    print("  ether_merge      {arch:11s} {dtype:8s} d={d:5d} "
                          "f={f:5d} n={n:2d}  err {rel_err:.2e} (tol "
                          "{tol:g})  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                          "bound {bound_ms:.4f} ms ({bound_by})"
                          .format(**rows[-1]), flush=True)
                    for t in ts:
                        x = torch.randn(t, d, generator=gen,
                                        device="cuda").to(dt)
                        ops.reset_launches()
                        err, rel = compare(ops.householder_gemm(x, ws[0], u),
                                           ref.ref_householder_gemm(
                                               x, ws[0], u), dtype)
                        route = routed(ops)
                        b_ms, b_by = bound(
                            (t * d + d * f + t * f) * es + 4 * d,
                            2 * t * d * f + 4 * t * d, dtype)
                        rows.append(dict(
                            kernel="householder_gemm", arch=arch, dtype=dtype,
                            t=t, d=d, f=f, n=n, route=route,
                            max_abs_err=err, rel_err=rel, tol=TOL[dtype],
                            ms=timed_ms(torch, [
                                lambda w=w: ops.householder_gemm(x, w, u)
                                for w in ws]),
                            plain_ms=timed_ms(torch, [
                                lambda w=w: ref.ref_householder_gemm(x, w, u)
                                for w in ws]),
                            matmul_ms=timed_ms(torch, [
                                lambda w=w: torch.matmul(x, w) for w in ws]),
                            bound_ms=b_ms, bound_by=b_by))
                        print("  householder_gemm {arch:11s} {dtype:8s} "
                              "d={d:5d} f={f:5d} n={n:2d} T={t:4d} "
                              "{route:12s}  err "
                              "{rel_err:.2e} (tol {tol:g})  {ms:.4f} ms  "
                              "plain {plain_ms:.4f} ms  matmul "
                              "{matmul_ms:.4f} ms  bound {bound_ms:.4f} ms "
                              "({bound_by})".format(**rows[-1]), flush=True)
                del ws
    torch.cuda.synchronize()
    return rows


def host_cost(torch, ops, execute, op="householder_gemm"):
    """Phase 2, host: µs a decode step's ``op`` call costs the host through
    ``ops.<op>`` and ``execute.dispatch``: ``householder_gemm`` (n =
    N_BLOCKS), ``hyperadapt_gemm`` (one tenant, T = B), or
    ``hyperadapt_gemm_batched`` or ``delora_gemm_batched`` (r =
    METHOD_RANK) through a BANK_TENANTS-tenant bank, ids BANK_IDS, S = 1.
    The calls cycle through one step's traffic: ARCH's 7 adapted
    linears a layer (q, k, v, o, gate, up, down) over all its layers, each
    weight with its own adapter, and each layer's four inputs (q/k/v's,
    o's, gate/up's, down's) at addresses of their own, so every call's
    operands sit where a decode step's do; whole steps of calls, at least
    HOST_CALLS, after two steps' warm-up.  Each step's calls are timed
    from a synchronize to the return of its last call, so the host's time
    is read, not the device's: a step's launches fit in the launch queue,
    where a long loop would wait on a slower kernel.  Where the tree's
    binding counts the wgmma routes' tensor-map encodes
    (``householder_gemm.map_counts``, ``batched.hyperadapt_map_counts``,
    ``batched.delora_map_counts``, ``hyperadapt_gemm.map_counts``), those
    of the timed calls are
    recorded too: 0 when the map cache holds a step's maps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import batched as kb
    from repro_torch.kernels import householder_gemm as hh
    from repro_torch.kernels import hyperadapt_gemm as kh
    cfg = get_config(ARCH, "full")
    d, hd = cfg.d_model, cfg.head_dim or cfg.d_model // cfg.n_heads
    q, kv, ff = cfg.n_heads * hd, cfg.n_kv * hd, cfg.d_ff
    # (input, d, f) of each adapted linear of a layer, in a step's order
    layer = ((0, d, q), (0, d, kv), (0, d, kv), (1, q, d), (2, d, ff),
             (2, d, ff), (3, ff, d))
    shape = {"householder_gemm": f"T={B}, n={N_BLOCKS}",
             "hyperadapt_gemm": f"T={B}",
             "hyperadapt_gemm_batched": f"B={B} S=1, A={BANK_TENANTS}",
             "delora_gemm_batched": f"B={B} S=1, r={METHOD_RANK}, "
                                    f"A={BANK_TENANTS}"}[op]
    print(f"== phase 2: host cost of a decode step's {op} calls ({ARCH}: "
          f"{len(layer)} x {cfg.n_layers} linears, {shape}, bf16)",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    ids = torch.tensor(BANK_IDS * (B // len(BANK_IDS)), dtype=torch.int32,
                       device="cuda")

    def adapter(k, f):
        """One linear's adapter operands after its weight."""
        if op == "householder_gemm":
            return (randn(N_BLOCKS, k // N_BLOCKS),)
        if op == "hyperadapt_gemm":
            return 1 + 0.3 * randn(k), 1 + 0.3 * randn(f)
        if op == "delora_gemm_batched":
            return (randn(BANK_TENANTS, k, METHOD_RANK),
                    randn(BANK_TENANTS, METHOD_RANK, f),
                    (randn(BANK_TENANTS, METHOD_RANK).abs() + 0.1).bfloat16(),
                    ids)
        return (1 + 0.3 * randn(BANK_TENANTS, k),
                1 + 0.3 * randn(BANK_TENANTS, f), ids)

    calls = []
    for _ in range(cfg.n_layers):
        xs = [randn(B, w).bfloat16() for w in (d, q, d, ff)]
        if op.endswith("_batched"):
            xs = [x.view(B, 1, -1) for x in xs]
        calls += [(xs[i], (randn(k, f) / k ** .5).bfloat16(), *adapter(k, f))
                  for i, k, f in layer]
    counts = {"householder_gemm": getattr(hh, "map_counts", None),
              "hyperadapt_gemm": getattr(kh, "map_counts", None),
              "hyperadapt_gemm_batched": getattr(kb, "hyperadapt_map_counts",
                                                 None),
              "delora_gemm_batched": getattr(kb, "delora_map_counts",
                                             None)}[op]
    steps = -(-HOST_CALLS // len(calls))
    out = {"arch": ARCH, "op": op, "linears": len(calls), "t": B,
           "n": N_BLOCKS if op == "householder_gemm" else None,
           "calls": steps * len(calls)}
    for name, fn in (
            ("ops", getattr(ops, op)),
            ("dispatch", lambda *a: execute.dispatch(op, "cuda", *a))):
        for _ in range(2):
            for call in calls:
                fn(*call)
        before = counts() if counts else None
        host_s = 0.0
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for call in calls:
                fn(*call)
            host_s += time.perf_counter() - t0
        torch.cuda.synchronize()
        out[f"{name}_us"] = host_s / out["calls"] * 1e6
        out[f"{name}_map_encodes"] = (counts()["encodes"] - before["encodes"]
                                      if counts else None)
    print(f"host cost: ops.{op} {out['ops_us']:.2f} us a call, "
          f"execute.dispatch {out['dispatch_us']:.2f} us a call "
          f"({out['calls']} calls each over {len(calls)} linears; tensor "
          f"maps encoded in them: {out['ops_map_encodes']}, "
          f"{out['dispatch_map_encodes']})", flush=True)
    return out


def etherplus_kernel_rows(torch, ops, ref, kepm):
    """Phase 2, ETHER+ forward: etherplus_gemm (two- and one-sided) and
    the left and right etherplus_merge kernels against their plain
    versions, on phase 2's shapes, with v1/v2 drawn apart from u1/u2 (a
    generator of their own).  The merges are held and timed one kernel
    at a time (``kepm``'s launchers; the left one also through the
    wrapper), the GEMM through its wrapper beside ``torch.matmul``, with
    the route its rule took; in bf16 each route, forced on the launcher,
    is also held to the plain version and timed (``route_ms``: the T = 4
    rows decide whether decode-size calls take ``wgmma``)."""
    from repro_torch.core.transforms import resolve_blocks
    from repro_torch.kernels import etherplus_gemm as kep
    print("== phase 2: ETHER+ kernels against their plain versions",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for arch, shapes in LINEARS.items():
            for d, f in shapes:
                w0 = randn(d, f) / d ** .5
                ws = [w0.to(dt).clone() for _ in
                      range(max(1, min(256, int(100e6 // (d * f * es)) + 1)))]
                for n in BLOCKS:
                    n_out = resolve_blocks(n, f)
                    u1, v1 = randn(n, d // n), randn(n, d // n)
                    u2, v2 = randn(n_out, f // n_out), randn(n_out, f // n_out)
                    common = dict(arch=arch, dtype=dtype, d=d, f=f, n=n,
                                  tol=TOL[dtype], matmul_ms=None)
                    w = ws[0]
                    ops.reset_launches()
                    left = ops.etherplus_merge(w, u1, v1)
                    check(ops.launches()["etherplus_merge_left"] == 1,
                          f"etherplus_merge launched {ops.launches()}")
                    err, rel = compare(left, ref.ref_etherplus_merge_left(
                        w, u1, v1), dtype, "etherplus_merge_left")
                    b_ms, b_by = bound(2 * d * f * es + 8 * d,
                                       8 * d * f + 6 * d, dtype)
                    rows.append(dict(
                        kernel="etherplus_merge_left", t=None, **common,
                        max_abs_err=err, rel_err=rel, bound_ms=b_ms,
                        bound_by=b_by,
                        ms=timed_ms(torch, [lambda w=w: kepm.launch_left(
                            w, u1, v1) for w in ws]),
                        plain_ms=timed_ms(torch, [
                            lambda w=w: ref.ref_etherplus_merge_left(w, u1, v1)
                            for w in ws])))
                    err, rel = compare(
                        launched(kepm.launch_right(w, u2, v2)),
                        ref.ref_etherplus_merge_right(w, u2, v2), dtype,
                        "etherplus_merge_right")
                    b_ms, b_by = bound(2 * d * f * es + 8 * f,
                                       8 * d * f + 6 * f, dtype)
                    rows.append(dict(
                        kernel="etherplus_merge_right", t=None, **common,
                        max_abs_err=err, rel_err=rel, bound_ms=b_ms,
                        bound_by=b_by,
                        ms=timed_ms(torch, [lambda w=w: kepm.launch_right(
                            w, u2, v2) for w in ws]),
                        plain_ms=timed_ms(torch, [
                            lambda w=w: ref.ref_etherplus_merge_right(
                                w, u2, v2) for w in ws])))
                    for r in rows[-2:]:
                        print("  {kernel:21s} {arch:11s} {dtype:8s} d={d:5d} "
                              "f={f:5d} n={n:2d}  err {rel_err:.2e} (tol "
                              "{tol:g})  {ms:.4f} ms  plain {plain_ms:.4f} ms"
                              "  bound {bound_ms:.4f} ms ({bound_by})"
                              .format(**r), flush=True)
                    for t in ROWS:
                        x = randn(t, d).to(dt)
                        for two in (True, False):
                            out = (u2, v2) if two else (None, None)
                            want = ref.ref_etherplus_gemm(x, w, u1, v1, *out)
                            ops.reset_launches()
                            err, rel = compare(
                                ops.etherplus_gemm(x, w, u1, v1, *out),
                                want, dtype, "etherplus_gemm")
                            route = routed(ops, "etherplus_gemm")
                            route_ms, epilogue_ms = {}, {}
                            for on in kep.ROUTES if dtype == "bfloat16" \
                                    else ():
                                compare(launched(kep.launch(
                                    x, w, u1, v1, *out, on=on))[0], want,
                                    dtype, f"etherplus_gemm on {on}")
                                route_ms[on] = timed_ms(torch, [
                                    lambda w=w, on=on: kep.launch(
                                        x, w, u1, v1, *out, on=on)
                                    for w in ws])
                            # each two-sided wgmma epilogue forced: fused
                            # where a tile holds a whole output block
                            for epi in ("fused", "scratch") if two and \
                                    dtype == "bfloat16" else ():
                                if epi == "fused" and not kep.tile_blocks(
                                        n_out, f // n_out):
                                    continue
                                compare(launched(kep.launch(
                                    x, w, u1, v1, *out, on="wgmma",
                                    epi=epi))[0], want, dtype,
                                    f"etherplus_gemm, {epi} epilogue")
                                epilogue_ms[epi] = timed_ms(torch, [
                                    lambda w=w, epi=epi: kep.launch(
                                        x, w, u1, v1, *out, on="wgmma",
                                        epi=epi) for w in ws])
                            b_ms, b_by = bound(
                                (t * d + d * f + t * f) * es + 8 * d
                                + (8 * f if two else 0),
                                2 * t * d * f + 8 * t * d
                                + (8 * t * f if two else 0), dtype)
                            rows.append(dict(
                                common, kernel="etherplus_gemm", t=t,
                                two_sided=two, max_abs_err=err, rel_err=rel,
                                route=route, route_ms=route_ms,
                                epilogue_ms=epilogue_ms,
                                epilogue=kep.epilogue(
                                    n_out if two else None, f // n_out),
                                bound_ms=b_ms, bound_by=b_by,
                                ms=timed_ms(torch, [
                                    lambda w=w: ops.etherplus_gemm(
                                        x, w, u1, v1, *out) for w in ws]),
                                plain_ms=timed_ms(torch, [
                                    lambda w=w: ref.ref_etherplus_gemm(
                                        x, w, u1, v1, *out) for w in ws]),
                                matmul_ms=timed_ms(torch, [
                                    lambda w=w: torch.matmul(x, w)
                                    for w in ws])))
                            print("  etherplus_gemm {s:3s}   {arch:11s} "
                                  "{dtype:8s} d={d:5d} f={f:5d} n={n:2d} "
                                  "T={t:4d} {route:5s} {epilogue:7s} err "
                                  "{rel_err:.2e} (tol {tol:g})"
                                  "  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                                  "matmul {matmul_ms:.4f} ms  bound "
                                  "{bound_ms:.4f} ms ({bound_by})".format(
                                      s="2s" if two else "1s", **rows[-1])
                                  + "".join(f"  {k} {v:.4f} ms" for k, v in
                                            route_ms.items())
                                  + "".join(f"  {k} epilogue {v:.4f} ms"
                                            for k, v in epilogue_ms.items()),
                                  flush=True)
                del ws, w
    torch.cuda.synchronize()
    return rows


def bwd_kernel_rows(torch, ops, ref, kdx, kdw, krb):
    """Phase 2, backward: reflect_gemm_dx (dx, du) and reflect_gemm_dw
    against their plain versions, through the wrapper; then each kernel
    timed through its own launcher (``kdx``, ``kdw``: the dW kernel runs
    alone there) beside its plain version and torch.matmul of the GEMM
    inside it (G·Wᵀ and xᵀ·G).  Then the same at rank 2 (ETHER+'s v,
    through ``ops.etherplus_gemm_bwd`` one-sided), and
    ``etherplus_reflect_bwd`` (``krb``) on the output side: y0 (T, f) of
    the one-sided product and G, with u2/v2 over f.  The ETHER+ operands
    come from a generator of their own, so the rank-1 rows see the inputs
    they always did."""
    from repro_torch.core.transforms import resolve_blocks
    gen = torch.Generator(device="cuda").manual_seed(1)
    gen2 = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    shapes = [(arch, d, f, n, t) for arch, lin in LINEARS.items()
              for d, f in lin for n in BLOCKS for t in BWD_ROWS]
    shapes += [(ARCH, d, f, 32, BWD_RAGGED) for d, f in LINEARS[ARCH]]
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for arch, d, f, n, t in shapes:
            w = (torch.randn(d, f, generator=gen, device="cuda")
                 / d ** .5).to(dt)
            x = torch.randn(t, d, generator=gen, device="cuda").to(dt)
            g = torch.randn(t, f, generator=gen, device="cuda").to(dt)
            u = torch.randn(n, d // n, generator=gen, device="cuda")
            ops.reset_launches()
            dx, dw, du = ops.householder_gemm_bwd(x, w, u, g, need_dw=True)
            torch.cuda.synchronize()
            check(ops.launches()["reflect_gemm_dx"] == 1
                  and ops.launches()["reflect_gemm_dw"] == 1,
                  f"householder_gemm_bwd launched {ops.launches()}")
            route = check_dx_route(ops, "reflect_gemm_dx", dt, d, f, n)
            pdx, pdu = ref.ref_reflect_gemm_dx(x, w, u, g)
            pdw = ref.ref_reflect_gemm_dw(x, u, g, dt)
            err = {k: ((a.float() - b.float()).abs().max().item(),
                       (a.float() - b.float()).abs().max().item()
                       / b.float().abs().max().item())
                   for k, a, b in (("dx", dx, pdx), ("dw", dw, pdw))}
            du_rel = ((du - pdu).norm() / pdu.norm()).item()
            check(err["dx"][1] <= TOL[dtype] and err["dw"][1] <= TOL[dtype]
                  and du_rel <= DU_TOL,
                  f"backward kernels disagree with their plain versions at "
                  f"{dtype} T={t} d={d} f={f} n={n}: dx {err['dx'][1]:.3e}, "
                  f"dw {err['dw'][1]:.3e} (tol {TOL[dtype]:g}), du "
                  f"{du_rel:.3e} (tol {DU_TOL:g})")
            dx_b = bound((2 * t * d + d * f + t * f) * es + 8 * d,
                         2 * t * d * f + 8 * t * d, dtype)
            dw_b = bound((t * d + t * f + d * f) * es + 4 * d,
                         2 * t * d * f + 4 * t * d, dtype)
            common = dict(arch=arch, dtype=dtype, t=t, d=d, f=f, n=n,
                          tol=TOL[dtype], rank=1)
            rows.append(dict(
                kernel="reflect_gemm_dx", **common, route=route,
                epilogue=dx_epilogue(route, n, d), max_abs_err=max(
                    err["dx"][0], (du - pdu).abs().max().item()),
                rel_err=err["dx"][1], du_rel_frob=du_rel,
                ms=timed_ms(torch, [lambda: kdx.launch(x, w, u, g)]),
                plain_ms=timed_ms(torch, [
                    lambda: ref.ref_reflect_gemm_dx(x, w, u, g)]),
                matmul_ms=timed_ms(torch, [lambda: torch.matmul(g, w.T)]),
                bound_ms=dx_b[0], bound_by=dx_b[1]))
            rows.append(dict(
                kernel="reflect_gemm_dw", **common,
                max_abs_err=err["dw"][0], rel_err=err["dw"][1],
                ms=timed_ms(torch, [lambda: kdw.launch(x, u, g)]),
                plain_ms=timed_ms(torch, [
                    lambda: ref.ref_reflect_gemm_dw(x, u, g, dt)]),
                matmul_ms=timed_ms(torch, [lambda: torch.matmul(x.T, g)]),
                bound_ms=dw_b[0], bound_by=dw_b[1]))
            rows += rank2_bwd_rows(torch, ops, ref, kdx, kdw, krb, gen2,
                                   resolve_blocks(n, f), x, w, g, u,
                                   dict(common, rank=2), es)
            for r in rows[-5:]:
                print("  {kernel:21s} r{rank} {arch:11s} {dtype:8s} T={t:4d} "
                      "d={d:5d} f={f:5d} n={n:2d}  err {rel_err:.2e} (tol "
                      "{tol:g})  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                      .format(**r)
                      + (f"matmul {r['matmul_ms']:.4f} ms  "
                         if r["matmul_ms"] else "")
                      + "bound {bound_ms:.4f} ms ({bound_by})".format(**r)
                      + (f"  du {r['du_rel_frob']:.2e}" if "du_rel_frob" in r
                         else "")
                      + (f"  {r['route']} ({r['epilogue']})" if "route" in r
                         else ""), flush=True)
            del w, x, g, dx, dw, pdx, pdw
    torch.cuda.synchronize()
    return rows


def rank2_bwd_rows(torch, ops, ref, kdx, kdw, krb, gen, n_out, x, w, g, u,
                   common, es):
    """The ETHER+ rows of one backward shape: rank-2 reflect_gemm_dx and
    reflect_gemm_dw (v drawn from ``gen``) and etherplus_reflect_bwd with
    u2/v2 (n_out, f/n_out) on y0 = (H⁺x)·W, each against its plain
    version, timed beside its plain version (and the matmul inside)."""
    dtype, t, d, f = common["dtype"], common["t"], common["d"], common["f"]
    dt = x.dtype
    v = torch.randn(u.shape, generator=gen, device="cuda")
    u2, v2 = (torch.randn(n_out, f // n_out, generator=gen, device="cuda")
              for _ in range(2))
    ops.reset_launches()
    dx, dw, du, dv, _, _ = ops.etherplus_gemm_bwd(x, w, u, v, None, None, g,
                                                  need_dw=True)
    check(ops.launches()["reflect_gemm_dx"] == 1
          and ops.launches()["reflect_gemm_dw"] == 1,
          f"rank-2 backward launched {ops.launches()}")
    route = check_dx_route(ops, "reflect_gemm_dx", dt, d, f, u.shape[0])
    y0 = ref.ref_etherplus_gemm(x, w, u, v)
    rdx, rdu, rdv = launched(krb.launch(y0, u2, v2, g))
    torch.cuda.synchronize()
    pdx, pdu, pdv = ref.ref_reflect_gemm_dx(x, w, u, g, v)
    pdw = ref.ref_reflect_gemm_dw(x, u, g, dt, v)
    prdx, prdu, prdv = ref.ref_etherplus_reflect_bwd(y0, u2, v2, g)

    def err(a, b):
        e = (a.float() - b.float()).abs().max().item()
        return e, e / b.float().abs().max().item()

    e = {k: err(a, b) for k, a, b in (("dx", dx, pdx), ("dw", dw, pdw),
                                       ("rb", rdx, prdx))}
    fr = {k: frob(a, b) for k, a, b in (("du", du, pdu), ("dv", dv, pdv),
                                         ("du2", rdu, prdu),
                                         ("dv2", rdv, prdv))}
    check(max(r for _, r in e.values()) <= TOL[dtype]
          and max(fr.values()) <= DU_TOL,
          f"rank-2 backward kernels disagree with their plain versions at "
          f"{dtype} T={t} d={d} f={f}: {e}, {fr} (tol {TOL[dtype]:g}, "
          f"{DU_TOL:g})")
    dx_b = bound((2 * t * d + d * f + t * f) * es + 16 * d,
                 2 * t * d * f + 16 * t * d, dtype)
    dw_b = bound((t * d + t * f + d * f) * es + 8 * d,
                 2 * t * d * f + 8 * t * d, dtype)
    rb_b = bound(3 * t * f * es + 16 * f, 20 * t * f, dtype)
    return [
        dict(common, kernel="reflect_gemm_dx", route=route,
             epilogue=dx_epilogue(route, u.shape[0], d),
             max_abs_err=max(e["dx"][0], (du - pdu).abs().max().item(),
                             (dv - pdv).abs().max().item()),
             rel_err=e["dx"][1], du_rel_frob=max(fr["du"], fr["dv"]),
             ms=timed_ms(torch, [lambda: kdx.launch(x, w, u, g, v)]),
             plain_ms=timed_ms(torch, [
                 lambda: ref.ref_reflect_gemm_dx(x, w, u, g, v)]),
             matmul_ms=timed_ms(torch, [lambda: torch.matmul(g, w.T)]),
             bound_ms=dx_b[0], bound_by=dx_b[1]),
        dict(common, kernel="reflect_gemm_dw", max_abs_err=e["dw"][0],
             rel_err=e["dw"][1],
             ms=timed_ms(torch, [lambda: kdw.launch(x, u, g, v)]),
             plain_ms=timed_ms(torch, [
                 lambda: ref.ref_reflect_gemm_dw(x, u, g, dt, v)]),
             matmul_ms=timed_ms(torch, [lambda: torch.matmul(x.T, g)]),
             bound_ms=dw_b[0], bound_by=dw_b[1]),
        dict(common, kernel="etherplus_reflect_bwd",
             max_abs_err=max(e["rb"][0], (rdu - prdu).abs().max().item(),
                             (rdv - prdv).abs().max().item()),
             rel_err=e["rb"][1], du_rel_frob=max(fr["du2"], fr["dv2"]),
             ms=timed_ms(torch, [lambda: krb.launch(y0, u2, v2, g)]),
             plain_ms=timed_ms(torch, [
                 lambda: ref.ref_etherplus_reflect_bwd(y0, u2, v2, g)]),
             matmul_ms=None, bound_ms=rb_b[0], bound_by=rb_b[1])]


def wide_bwd_rows(torch, ops, ref, kdx, kb):
    """Phase 2, the dXr backwards at Llama-2-7B's linears (WIDE_LINEARS),
    bf16 only, n = TRAIN_BLOCKS, T = B·S of WIDE_BWD_BANK rows: where the
    tensor cores, not the host, set the pace.  reflect_gemm_dx (rank 1)
    and householder_gemm_batched_bwd (WIDE_BWD_BANK sequences of a
    BANK_TENANTS-tenant bank, ids BANK_IDS repeated) through their
    wrappers against their plain versions (dx to TOL, du to DU_TOL), each
    row's route and epilogue printed, each timed through its launcher
    beside its plain version and torch.matmul(g, w.T)."""
    print("== phase 2: the dXr backwards at Llama-2-7B's linears",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    dtype, dt, es, n = "bfloat16", torch.bfloat16, 2, TRAIN_BLOCKS
    b, s = WIDE_BWD_BANK
    t = b * s
    ids = torch.tensor((BANK_IDS * b)[:b], dtype=torch.int32, device="cuda")
    named = len(set(BANK_IDS))
    rows = []
    for arch, shapes in WIDE_LINEARS.items():
        for d, f in shapes:
            w = (torch.randn(d, f, generator=gen, device="cuda")
                 / d ** .5).to(dt)
            x = torch.randn(t, d, generator=gen, device="cuda").to(dt)
            g = torch.randn(t, f, generator=gen, device="cuda").to(dt)
            u = torch.randn(n, d // n, generator=gen, device="cuda")
            ub = torch.randn(BANK_TENANTS, n, d // n, generator=gen,
                             device="cuda")
            xb, gb = x.view(b, s, d), g.view(b, s, f)
            mm = timed_ms(torch, [lambda: torch.matmul(g, w.T)])
            for kernel in ("reflect_gemm_dx", "householder_gemm_batched_bwd"):
                ops.reset_launches()
                if kernel == "reflect_gemm_dx":
                    dx, _, du = ops.householder_gemm_bwd(x, w, u, g,
                                                         need_dw=False)
                    pdx, pdu = ref.ref_reflect_gemm_dx(x, w, u, g)
                    run = (lambda: kdx.launch(x, w, u, g))
                    plain = (lambda: ref.ref_reflect_gemm_dx(x, w, u, g))
                    extra = 8 * d
                    keys = dict(rank=1)
                else:
                    dx, _, du = ops.householder_gemm_batched_bwd(
                        xb, w, ub, ids, gb, need_dw=False)
                    pdx, pgh = ref.ref_householder_gemm_batched_bwd(
                        xb, w, ub, ids, gb)
                    pdu = ref.bank_grad(ub, ids, pgh)
                    run = (lambda: kb.householder_gemm_batched_bwd(
                        xb, w, ub, ids, gb))
                    plain = (lambda: ref.ref_householder_gemm_batched_grads(
                        xb, w, ub, ids, gb, need_dw=False))
                    extra = 4 * b + 4 * d * named + 4 * BANK_TENANTS * d
                    keys = dict(b=b, s=s, tenants=BANK_TENANTS)
                torch.cuda.synchronize()
                route = check_dx_route(ops, kernel, dt, d, f, n)
                err = (dx.float() - pdx.float()).abs().max().item()
                rel = err / pdx.float().abs().max().item()
                du_rel = frob(du, pdu)
                check(rel <= TOL[dtype] and du_rel <= DU_TOL,
                      f"{kernel} disagrees with its plain version at "
                      f"{arch} d={d} f={f} T={t}: dx {rel:.3e} (tol "
                      f"{TOL[dtype]:g}), du {du_rel:.3e} (tol {DU_TOL:g})")
                b_ms, b_by = bound((2 * t * d + d * f + t * f) * es + extra,
                                   2 * t * d * f + 8 * t * d, dtype)
                rows.append(dict(
                    kernel=kernel, arch=arch, dtype=dtype, t=t, d=d, f=f,
                    n=n, **keys, route=route,
                    epilogue=dx_epilogue(route, n, d),
                    max_abs_err=max(err, (du - pdu).abs().max().item()),
                    rel_err=rel, tol=TOL[dtype], du_rel_frob=du_rel,
                    ms=timed_ms(torch, [run]),
                    plain_ms=timed_ms(torch, [plain]), matmul_ms=mm,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None))
                r = rows[-1]
                print(f"  {kernel:29s} {arch} T={t} d={d:5d} f={f:5d} n={n} "
                      f"{route} ({r['epilogue']})  err {rel:.2e}  du "
                      f"{du_rel:.2e}  {r['ms']:.4f} ms  plain "
                      f"{r['plain_ms']:.4f} ms  matmul {mm:.4f} ms "
                      f"(x{r['ms'] / max(mm, 1e-9):.2f})  bound {b_ms:.4f} "
                      f"ms ({b_by}, {100 * b_ms / max(r['ms'], 1e-9):.1f}% "
                      f"of it)", flush=True)
                del dx, du, pdx, pdu
            del w, x, g, xb, gb
    torch.cuda.synchronize()
    return rows


def method_kernel_rows(torch, ops, ref):
    """Phase 2, DeLoRA and HyperAdapt: delora_gemm (r ∈ METHOD_RANKS) and
    hyperadapt_gemm at the forward rows, delora_merge and hyperadapt_merge
    on the weights, and the backward compositions delora_gemm_bwd and
    hyperadapt_gemm_bwd (no dW: PEFT) at the backward rows, each through
    its wrapper against its plain version, timed beside it and beside
    ``torch.matmul`` of the GEMM inside (``torch.addmm`` for
    delora_merge).  Every operand is off the methods' identity init (b ≠
    0, r and c ≠ 1), from a generator of its own.  hyperadapt_gemm's rows
    and its backward's carry the route its rule took and, in bf16, each
    route forced, held to the plain version and timed (``route_ms``)."""
    from repro_torch.kernels import hyperadapt_gemm as kh
    print("== phase 2: DeLoRA and HyperAdapt kernels against their plain "
          "versions", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def errs(pairs):
        """(max abs error, normalised max error) over a row's outputs."""
        e = [((a.float() - b.float()).abs().max().item(),
              b.float().abs().max().item()) for a, b in pairs]
        return max(x for x, _ in e), max(x / m for x, m in e)

    def add(kernel, dtype, pairs, **kw):
        err, rel = errs(pairs)
        check(rel <= METHOD_TOL[dtype], f"{kernel} disagrees with its plain "
              f"version at {kw}: {rel:.3e} > {METHOD_TOL[dtype]:g}")
        row = dict(kernel=kernel, dtype=dtype, max_abs_err=err, rel_err=rel,
                   tol=METHOD_TOL[dtype], n=None, **kw)
        row.setdefault("matmul_ms", None)
        row.setdefault("library_ms", None)
        rows.append(row)
        print("  {kernel:19s} {arch:11s} {dtype:8s} r={r!s:4s} T={t!s:4s} "
              "d={d:5d} f={f:5d}  err {rel_err:.2e} (tol {tol:g})  "
              "{ms:.4f} ms  plain {plain_ms:.4f} ms  ".format(**row)
              + (f"matmul {row['matmul_ms']:.4f} ms  " if row["matmul_ms"]
                 else "")
              + (f"addmm {row['library_ms']:.4f} ms  " if row["library_ms"]
                 else "")
              + "bound {bound_ms:.4f} ms ({bound_by})".format(**row)
              + (f"  route {row['route']}" + "".join(
                  f"  {k} {v:.4f} ms" for k, v in row["route_ms"].items())
                 if "route" in row else ""), flush=True)

    def routes_forced(kernel, dtype, run, want):
        """The route hyperadapt_gemm's rule took on the row's wrapper call,
        made just before; and ``run(on)``, ``kernel`` on each route forced,
        in bf16: held to ``want`` (METHOD_TOL) and timed."""
        route, route_ms = routed(ops, "hyperadapt_gemm"), {}
        for on in kh.ROUTES if dtype == "bfloat16" else ():
            _, rel = errs(zip(run(on), want))
            check(rel <= METHOD_TOL[dtype], f"{kernel} on {on} disagrees "
                  f"with its plain version: {rel:.3e}")
            route_ms[on] = timed_ms(torch, [lambda: run(on)])
        return dict(route=route, route_ms=route_ms)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for arch, shapes in LINEARS.items():
            for d, f in shapes:
                w0 = randn(d, f) / d ** .5
                ws = [w0.to(dt).clone() for _ in
                      range(max(1, min(256, int(100e6 // (d * f * es)) + 1)))]
                w = ws[0]
                rr, c = 1 + 0.3 * randn(d), 1 + 0.3 * randn(f)
                lr = {r: (randn(d, r), randn(r, f),
                          (randn(r).abs() + 0.1).to(dt))
                      for r in METHOD_RANKS}
                common = dict(arch=arch, d=d, f=f)
                for r, (a, b, sv) in lr.items():
                    as_, bb = (a * sv.float()).to(dt), b.to(dt)
                    add("delora_merge", dtype,
                        [(ops.delora_merge(w, a, b, sv),
                          ref.ref_delora_merge(w, a, b, sv))],
                        t=None, r=r, **common,
                        ms=timed_ms(torch, [lambda w=w: ops.delora_merge(
                            w, a, b, sv) for w in ws]),
                        plain_ms=timed_ms(torch, [
                            lambda w=w: ref.ref_delora_merge(w, a, b, sv)
                            for w in ws]),
                        library_ms=timed_ms(torch, [
                            lambda w=w: torch.addmm(w, as_, bb) for w in ws]),
                        **dict(zip(("bound_ms", "bound_by"), bound(
                            2 * d * f * es + 4 * r * (d + f) + r * es,
                            2 * d * f * r + d * r + d * f, dtype))))
                add("hyperadapt_merge", dtype,
                    [(ops.hyperadapt_merge(w, rr, c),
                      ref.ref_hyperadapt_merge(w, rr, c))],
                    t=None, r=None, **common,
                    ms=timed_ms(torch, [lambda w=w: ops.hyperadapt_merge(
                        w, rr, c) for w in ws]),
                    plain_ms=timed_ms(torch, [
                        lambda w=w: ref.ref_hyperadapt_merge(w, rr, c)
                        for w in ws]),
                    **dict(zip(("bound_ms", "bound_by"), bound(
                        2 * d * f * es + 4 * (d + f), 2 * d * f, dtype))))
                for t in ROWS:
                    x = randn(t, d).to(dt)
                    mm = timed_ms(torch, [lambda w=w: torch.matmul(x, w)
                                          for w in ws])
                    for r, (a, b, sv) in lr.items():
                        add("delora_gemm", dtype,
                            [(ops.delora_gemm(x, w, a, b, sv),
                              ref.ref_delora_gemm(x, w, a, b, sv))],
                            t=t, r=r, **common, matmul_ms=mm,
                            ms=timed_ms(torch, [
                                lambda w=w: ops.delora_gemm(x, w, a, b, sv)
                                for w in ws]),
                            plain_ms=timed_ms(torch, [
                                lambda w=w: ref.ref_delora_gemm(x, w, a, b, sv)
                                for w in ws]),
                            **dict(zip(("bound_ms", "bound_by"), bound(
                                (t * d + d * f + t * f) * es
                                + 4 * r * (d + f) + r * es,
                                2 * t * d * f + 2 * t * r * (d + f)
                                + t * (r + f), dtype))))
                    ops.reset_launches()
                    got = ops.hyperadapt_gemm(x, w, rr, c)
                    want = ref.ref_hyperadapt_gemm(x, w, rr, c)
                    add("hyperadapt_gemm", dtype, [(got, want)],
                        t=t, r=None, **common, matmul_ms=mm,
                        **routes_forced(
                            "hyperadapt_gemm", dtype,
                            lambda on: [launched(kh.launch(
                                x, w, rr, c, on=on))[0]], [want]),
                        ms=timed_ms(torch, [
                            lambda w=w: ops.hyperadapt_gemm(x, w, rr, c)
                            for w in ws]),
                        plain_ms=timed_ms(torch, [
                            lambda w=w: ref.ref_hyperadapt_gemm(x, w, rr, c)
                            for w in ws]),
                        **dict(zip(("bound_ms", "bound_by"), bound(
                            (t * d + d * f + t * f) * es + 4 * (d + f),
                            2 * t * d * f + t * (d + f), dtype))))
                del ws, w

        # the backward compositions, at phase 2's backward rows
        shapes = [(arch, d, f, t) for arch, lin in LINEARS.items()
                  for d, f in lin for t in BWD_ROWS]
        shapes += [(ARCH, d, f, BWD_RAGGED) for d, f in LINEARS[ARCH]]
        for arch, d, f, t in shapes:
            w = (randn(d, f) / d ** .5).to(dt)
            x, g = randn(t, d).to(dt), randn(t, f).to(dt)
            rr, c = 1 + 0.3 * randn(d), 1 + 0.3 * randn(f)
            common = dict(arch=arch, d=d, f=f, t=t)
            mm = timed_ms(torch, [lambda: torch.matmul(g, w.T)])
            for r in METHOD_RANKS:
                a, b, sv = randn(d, r), randn(r, f), (randn(r).abs()
                                                      + 0.1).to(dt)
                ops.reset_launches()
                got = ops.delora_gemm_bwd(x, w, a, b, sv, g, need_dw=False)
                check(ops.launches()["delora_gemm"] == 1 and got[1] is None,
                      f"delora_gemm_bwd launched {ops.launches()}")
                want = ref.ref_delora_gemm_bwd(x, w, a, b, sv, g,
                                               need_dw=False)
                add("delora_gemm_bwd", dtype,
                    [(p, q) for p, q in zip(got, want) if q is not None],
                    r=r, **common, matmul_ms=mm,
                    ms=timed_ms(torch, [lambda: ops.delora_gemm_bwd(
                        x, w, a, b, sv, g, need_dw=False)]),
                    plain_ms=timed_ms(torch, [lambda: ref.ref_delora_gemm_bwd(
                        x, w, a, b, sv, g, need_dw=False)]),
                    **dict(zip(("bound_ms", "bound_by"), bound(
                        (2 * t * d + d * f + t * f) * es + 8 * r * (d + f)
                        + 2 * r * es,
                        2 * t * d * f + 6 * t * r * (d + f) + 2 * t * r,
                        dtype))))
            ops.reset_launches()
            got = ops.hyperadapt_gemm_bwd(x, w, rr, c, g, need_dw=False)
            check(ops.launches()["hyperadapt_gemm"] == 2 and got[1] is None,
                  f"hyperadapt_gemm_bwd launched {ops.launches()}")
            want = ref.ref_hyperadapt_gemm_bwd(x, w, rr, c, g, need_dw=False)
            pairs = [(p, q) for p, q in zip(got, want) if q is not None]

            def bwd_on(on):
                with forced_route(kh, "route", on):
                    return [p for p, q in zip(ops.hyperadapt_gemm_bwd(
                        x, w, rr, c, g, need_dw=False), want)
                        if q is not None]
            add("hyperadapt_gemm_bwd", dtype, pairs,
                r=None, **common,
                **routes_forced("hyperadapt_gemm_bwd", dtype, bwd_on,
                                [q for q in want if q is not None]),
                matmul_ms=mm + timed_ms(torch, [lambda: torch.matmul(x, w)]),
                ms=timed_ms(torch, [lambda: ops.hyperadapt_gemm_bwd(
                    x, w, rr, c, g, need_dw=False)]),
                plain_ms=timed_ms(torch, [lambda: ref.ref_hyperadapt_gemm_bwd(
                    x, w, rr, c, g, need_dw=False)]),
                **dict(zip(("bound_ms", "bound_by"), bound(
                    (2 * t * d + d * f + t * f) * es + 8 * (d + f),
                    4 * t * d * f + 4 * t * d + 3 * t * f, dtype))))
            del w, x, g
    torch.cuda.synchronize()
    return rows


def staged_tiles(ids, seq, count):
    """The tiles expected to stage: (row tiles whose rows name one tenant,
    row tiles) of the scaled core's low-rank epilogue on ids, ``seq`` rows
    a sequence: 16-row tiles at 16 rows or fewer, else 128-row ones; the
    first stage b_t.  Phase 2 holds the kernel's own count to it."""
    from repro_torch.kernels import ref
    t = ref.bank_index(ids.cpu(), count).tolist()
    m = len(t) * seq
    rows = 16 if m <= 16 else 128
    tiles = [{t[i // seq] for i in range(r0, min(r0 + rows, m))}
             for r0 in range(0, m, rows)]
    return sum(len(x) == 1 for x in tiles), len(tiles)


def bank_kernel_rows(torch, ops, ref):
    """Phase 2, multi-tenant banks: householder_gemm_batched,
    etherplus_reflect_batched (a linear's two sides: H⁺ on x over d, then
    on y0 = x·W over f, timed together), delora_gemm_batched (r ∈
    METHOD_RANKS) and hyperadapt_gemm_batched on smollm-360m's four
    linear shapes, n = 8, at BANK_ROWS, with a BANK_TENANTS-tenant bank
    and ids BANK_IDS (a repeat and A − 1), every tenant drawn apart from
    the others and off its method's identity, from a generator of its
    own.  Each through its wrapper against its plain version (TOL), timed
    beside it and, for the three GEMMs, beside ``torch.matmul`` of the
    product inside; the reflection's row carries the matmul between its
    two calls.  householder_gemm_batched's rows carry the route its rule
    took and, in bf16, each route forced on the launcher, held to the
    plain version and timed (``route_ms``: the rows decide the S from which
    the bank takes ``wgmma``)."""
    from repro_torch.core.transforms import resolve_blocks
    from repro_torch.kernels import batched as kb
    print("== phase 2: bank kernels against their plain versions "
          f"(A={BANK_TENANTS}, ids {BANK_IDS})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    wide = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    a_n = BANK_TENANTS

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def add(kernel, dtype, got, want, **kw):
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        check(rel <= TOL[dtype], f"{kernel} disagrees with its plain version "
              f"at {kw}: {rel:.3e} > {TOL[dtype]:g}")
        row = dict(kernel=kernel, arch=ARCH, dtype=dtype, max_abs_err=err,
                   rel_err=rel, tol=TOL[dtype], tenants=a_n,
                   library_ms=None, **kw)
        rows.append(row)
        print("  {kernel:25s} {dtype:8s} B={b:2d} S={s:3d} d={d:4d} f={f:4d} "
              "r={r!s:4s} err {rel_err:.2e} (tol {tol:g})  {ms:.4f} ms  "
              "plain {plain_ms:.4f} ms  matmul {matmul_ms:.4f} ms  bound "
              "{bound_ms:.4f} ms ({bound_by})".format(**row)
              + (f"  route {row['route']}" + "".join(
                  f"  {k} {v:.4f} ms" for k, v in row["route_ms"].items())
                 if "route" in row else "")
              + ("".join(f"  epilogue {k} {v:.4f} ms" for k, v in
                         row["lowrank_ms"].items())
                 + "  tiles staged {}/{}".format(*row["staged_tiles"])
                 if row.get("lowrank_ms") else ""), flush=True)

    def gemm_row(dtype, es, x, w, ws, u, ids, got, common):
        """householder_gemm_batched's row: ``got`` (the wrapper's output)
        and each route forced held to the plain version, and timed."""
        b, s, d = x.shape
        m, f = b * s, w.shape[1]
        tenants = len(set(ids.tolist()))   # rows of the bank read
        want = ref.ref_householder_gemm_batched(x, w, u, ids)
        route, route_ms = routed(ops, "householder_gemm_batched"), {}
        for on in kb.GEMM_ROUTES if dtype == "bfloat16" else ():
            compare(launched(kb.householder_gemm_batched(
                x, w, u, ids, on=on))[0], want, dtype,
                f"householder_gemm_batched on {on}")
            route_ms[on] = timed_ms(torch, [
                lambda w=w, on=on: kb.householder_gemm_batched(
                    x, w, u, ids, on=on) for w in ws])
        add("householder_gemm_batched", dtype, got, want, n=N_BLOCKS,
            r=None, route=route, route_ms=route_ms, **common,
            ms=timed_ms(torch, [
                lambda w=w: ops.householder_gemm_batched(x, w, u, ids)
                for w in ws]),
            plain_ms=timed_ms(torch, [
                lambda w=w: ref.ref_householder_gemm_batched(
                    x, w, u, ids) for w in ws]),
            **dict(zip(("bound_ms", "bound_by"), bound(
                (m * d + d * f + m * f) * es + 4 * b + 4 * d * tenants,
                2 * m * d * f + 4 * m * d, dtype))))

    def dl_routes(dtype, x, w, ws, ab, bb, sb, ids, got):
        """delora_gemm_batched's row: the route its rule took on the
        wrapper's call ``got``, made just before; in bf16 each route forced
        held to the plain version and timed, and the wgmma route's
        epilogue timed both ways (``lowrank_ms``: b_t staged in shared
        memory where a tile names one tenant, or read with __ldg at every
        tile; the same bits), with the row tiles that staged and all row
        tiles, counted by the kernel and held to :func:`staged_tiles`."""
        route, route_ms, lowrank_ms = routed(ops, "delora_gemm_batched"), \
            {}, {}
        want = ref.ref_delora_gemm_batched(x, w, ab, bb, sb, ids)
        for on in kb.DL_ROUTES if dtype == "bfloat16" else ():
            y = launched(kb.delora_gemm_batched(x, w, ab, bb, sb, ids,
                                                on=on))[0]
            compare(y, want, dtype, f"delora_gemm_batched on {on}")
            route_ms[on] = timed_ms(torch, [
                lambda w=w, on=on: kb.delora_gemm_batched(
                    x, w, ab, bb, sb, ids, on=on) for w in ws])
        counted = None
        if dtype == "bfloat16":
            expected = staged_tiles(ids, x.shape[1], a_n)
            for stage in (True, False):
                # the tiles that staged, as the kernel counts them
                tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
                y = launched(kb.delora_gemm_batched(
                    x, w, ab, bb, sb, ids, on="wgmma", stage=stage,
                    staged=tiles))[0]
                check(torch.equal(y, got), "delora_gemm_batched's epilogue "
                      f"(stage={stage}) changed the wgmma route's bits")
                tiles = tuple(tiles.tolist())
                want_tiles = (expected[0] if stage else 0, expected[1])
                check(tiles == want_tiles, "delora_gemm_batched's epilogue "
                      f"(stage={stage}) staged {tiles[0]} of {tiles[1]} row "
                      f"tiles, not the {want_tiles[0]} of {want_tiles[1]} "
                      "whose rows name one tenant")
                if stage:
                    counted = tiles
                lowrank_ms["staged" if stage else "ldg"] = timed_ms(torch, [
                    lambda w=w, stage=stage: kb.delora_gemm_batched(
                        x, w, ab, bb, sb, ids, on="wgmma", stage=stage)
                    for w in ws])
        return dict(route=route, route_ms=route_ms, lowrank_ms=lowrank_ms,
                    staged_tiles=counted)

    def ha_row(dtype, es, x, w, ws, rb, cb, ids, common):
        """hyperadapt_gemm_batched's row: the wrapper's output and, in bf16,
        each route forced held to the plain version, and timed."""
        b, s, d = x.shape
        m, f = b * s, w.shape[1]
        tenants = len(set(ids.tolist()))   # rows of the bank read
        ops.reset_launches()
        got = ops.hyperadapt_gemm_batched(x, w, rb, cb, ids)
        check(ops.launches()["hyperadapt_gemm_batched"] == 1,
              f"hyperadapt_gemm_batched launched {ops.launches()}")
        route = routed(ops, "hyperadapt_gemm_batched")
        want = ref.ref_hyperadapt_gemm_batched(x, w, rb, cb, ids)
        route_ms = {}
        for on in kb.HA_ROUTES if dtype == "bfloat16" else ():
            compare(launched(kb.hyperadapt_gemm_batched(
                x, w, rb, cb, ids, on=on))[0], want, dtype,
                f"hyperadapt_gemm_batched on {on}")
            route_ms[on] = timed_ms(torch, [
                lambda w=w, on=on: kb.hyperadapt_gemm_batched(
                    x, w, rb, cb, ids, on=on) for w in ws])
        add("hyperadapt_gemm_batched", dtype, got, want, n=None, r=None,
            route=route, route_ms=route_ms, **common,
            ms=timed_ms(torch, [
                lambda w=w: ops.hyperadapt_gemm_batched(x, w, rb, cb, ids)
                for w in ws]),
            plain_ms=timed_ms(torch, [
                lambda w=w: ref.ref_hyperadapt_gemm_batched(
                    x, w, rb, cb, ids) for w in ws]),
            **dict(zip(("bound_ms", "bound_by"), bound(
                (m * d + d * f + m * f) * es + 4 * b
                + 4 * (d + f) * tenants,
                2 * m * d * f + m * (d + f), dtype))))

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for d, f in LINEARS[ARCH]:
            w0 = randn(d, f) / d ** .5
            ws = [w0.to(dt).clone() for _ in
                  range(max(1, min(256, int(100e6 // (d * f * es)) + 1)))]
            w = ws[0]
            n_out = resolve_blocks(N_BLOCKS, f)
            u, v = randn(a_n, N_BLOCKS, d // N_BLOCKS), randn(
                a_n, N_BLOCKS, d // N_BLOCKS)
            u2, v2 = randn(a_n, n_out, f // n_out), randn(a_n, n_out,
                                                           f // n_out)
            rb, cb = 1 + 0.3 * randn(a_n, d), 1 + 0.3 * randn(a_n, f)
            lr = {r: (randn(a_n, d, r), randn(a_n, r, f),
                      (randn(a_n, r).abs() + 0.1).to(dt))
                  for r in METHOD_RANKS}
            for b, s in BANK_ROWS:
                ids = torch.tensor(BANK_IDS * (b // len(BANK_IDS)),
                                   dtype=torch.int32, device="cuda")
                tenants = len(set(ids.tolist()))   # rows of the bank read
                m = b * s
                x = randn(b, s, d).to(dt)
                y0 = torch.matmul(x, w)
                mm = timed_ms(torch, [lambda w=w: torch.matmul(x, w)
                                      for w in ws])
                io = (m * d + d * f + m * f) * es + 4 * b  # x, W, y, ids
                common = dict(b=b, s=s, t=m, d=d, f=f, matmul_ms=mm)
                ops.reset_launches()
                got = ops.householder_gemm_batched(x, w, u, ids)
                check(ops.launches()["householder_gemm_batched"] == 1,
                      f"householder_gemm_batched launched {ops.launches()}")
                gemm_row(dtype, es, x, w, ws, u, ids, got, common)
                got = torch.cat([
                    ops.etherplus_reflect_batched(x, u, v, ids).flatten(),
                    ops.etherplus_reflect_batched(y0, u2, v2, ids).flatten()])
                want = torch.cat([
                    ref.ref_etherplus_reflect_batched(x, u, v, ids).flatten(),
                    ref.ref_etherplus_reflect_batched(y0, u2, v2, ids)
                    .flatten()])
                add("etherplus_reflect_batched", dtype, got, want, n=N_BLOCKS,
                    r=None, **common,
                    ms=timed_ms(torch, [lambda: (
                        ops.etherplus_reflect_batched(x, u, v, ids),
                        ops.etherplus_reflect_batched(y0, u2, v2, ids))]),
                    plain_ms=timed_ms(torch, [lambda: (
                        ref.ref_etherplus_reflect_batched(x, u, v, ids),
                        ref.ref_etherplus_reflect_batched(y0, u2, v2, ids))]),
                    **dict(zip(("bound_ms", "bound_by"), bound(
                        2 * m * (d + f) * es + 8 * b + 8 * (d + f) * tenants,
                        8 * m * (d + f), dtype))))
                for r, (ab, bb, sb) in lr.items():
                    ops.reset_launches()
                    got = ops.delora_gemm_batched(x, w, ab, bb, sb, ids)
                    add("delora_gemm_batched", dtype, got,
                        ref.ref_delora_gemm_batched(x, w, ab, bb, sb, ids),
                        n=None, r=r, **common,
                        **dl_routes(dtype, x, w, ws, ab, bb, sb, ids, got),
                        ms=timed_ms(torch, [
                            lambda w=w: ops.delora_gemm_batched(
                                x, w, ab, bb, sb, ids) for w in ws]),
                        plain_ms=timed_ms(torch, [
                            lambda w=w: ref.ref_delora_gemm_batched(
                                x, w, ab, bb, sb, ids) for w in ws]),
                        **dict(zip(("bound_ms", "bound_by"), bound(
                            io + (4 * r * (d + f) + r * es) * tenants,
                            2 * m * d * f + 2 * m * r * (d + f) + m * r,
                            dtype))))
                ha_row(dtype, es, x, w, ws, rb, cb, ids, common)
            if dtype == "bfloat16":
                # the wide decode row, from a generator of its own (the
                # other rows' inputs stay as they were)
                b, s = BANK_WIDE_DECODE
                x = torch.randn(b, s, d, generator=wide, device="cuda").to(dt)
                ids = torch.arange(b, dtype=torch.int32, device="cuda") % a_n
                ops.reset_launches()
                got = ops.householder_gemm_batched(x, w, u, ids)
                check(ops.launches()["householder_gemm_batched"] == 1,
                      f"householder_gemm_batched launched {ops.launches()}")
                common = dict(b=b, s=s, t=b * s, d=d, f=f, matmul_ms=timed_ms(
                    torch, [lambda w=w: torch.matmul(x, w) for w in ws]))
                gemm_row(dtype, es, x, w, ws, u, ids, got, common)
                ha_row(dtype, es, x, w, ws, rb, cb, ids, common)
            del ws, w
    torch.cuda.synchronize()
    return rows


def bank_bwd_rows(torch, ops, ref, kb):
    """Phase 2, training through a bank: householder_gemm_batched_bwd (dx,
    ĝ_seq, du_bank), householder_gemm_batched_dw and
    etherplus_reflect_batched_bwd (a linear's two sides: x over d with
    u/v, y0 = x·W over f with u2/v2) through their wrappers against their
    plain versions, on smollm-360m's four linear shapes with a
    BANK_TENANTS-tenant bank, ids BANK_IDS (a repeat and A − 1) repeated
    to B, at BANK_BWD_ROWS and n ∈ BLOCKS, bf16 and f32: dx and dW to TOL,
    du, dv and ĝ to DU_TOL (relative Frobenius), the tenants no id names
    exactly zero.  Each timed through its launcher (``kb``) beside its
    plain version and torch.matmul of the GEMM inside (G·Wᵀ for the dx
    kernel, xᵀ·G for dW; for the reflection pair, the G·Wᵀ between its two
    calls in the backward).  Then DeLoRA's and HyperAdapt's bank backward
    compositions (rank METHOD_RANK, no dW) against theirs, to
    METHOD_TOL.  Operands from a generator of their own."""
    from repro_torch.core.transforms import resolve_blocks
    print("== phase 2: bank backward kernels against their plain versions "
          f"(A={BANK_TENANTS}, ids {BANK_IDS})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    a_n = BANK_TENANTS

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def err(got, want):
        e = (got.float() - want.float()).abs().max().item()
        return e, e / want.float().abs().max().item()

    def add(row):
        rows.append(row)
        print("  {kernel:29s} {dtype:8s} B={b:2d} S={s:3d} d={d:4d} f={f:4d} "
              "n={n!s:4s} err {rel_err:.2e} (tol {tol:g})  du {du_rel_frob:.2e}"
              "  {ms:.4f} ms  plain {plain_ms:.4f} ms  matmul {matmul_ms:.4f} "
              "ms  bound {bound_ms:.4f} ms ({bound_by})".format(**row)
              + (f"  {row['route']} ({row['epilogue']})" if "epilogue" in row
                 else f"  route {row['route']}" + "".join(
                     f"  {k} {v:.4f} ms" for k, v in row["route_ms"].items())
                 if "route" in row else ""), flush=True)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for d, f in LINEARS[ARCH]:
            w = (randn(d, f) / d ** .5).to(dt)
            rb, cb = 1 + 0.3 * randn(a_n, d), 1 + 0.3 * randn(a_n, f)
            ab, bb = randn(a_n, d, METHOD_RANK), randn(a_n, METHOD_RANK, f)
            sb = (randn(a_n, METHOD_RANK).abs() + 0.1).to(dt)
            for b, s in BANK_BWD_ROWS:
                ids = torch.tensor(BANK_IDS * (b // len(BANK_IDS))
                                   + BANK_IDS[:b % len(BANK_IDS)],
                                   dtype=torch.int32, device="cuda")
                named = sorted(set(ids.tolist()))
                m = b * s
                x, g = randn(b, s, d).to(dt), randn(b, s, f).to(dt)
                gx = randn(b, s, d).to(dt)      # the input side's cotangent
                y0 = torch.matmul(x, w)
                touched = torch.zeros(a_n, dtype=torch.bool)
                touched[named] = True
                common = dict(arch=ARCH, dtype=dtype, b=b, s=s, t=m, d=d,
                              f=f, tenants=a_n, library_ms=None)
                mm_dx = timed_ms(torch, [lambda: torch.matmul(g, w.T)])
                mm_dw = timed_ms(torch, [lambda: torch.matmul(
                    x.view(m, d).T, g.view(m, f))])
                for n in BLOCKS:
                    n_out = resolve_blocks(n, f)
                    u, v = randn(a_n, n, d // n), randn(a_n, n, d // n)
                    u2, v2 = (randn(a_n, n_out, f // n_out)
                              for _ in range(2))
                    ops.reset_launches()
                    dx, dw, du = ops.householder_gemm_batched_bwd(
                        x, w, u, ids, g, need_dw=True)
                    rx, ru, rv = ops.etherplus_reflect_batched_bwd(
                        x, u, v, ids, gx)
                    ox, ou, ov = ops.etherplus_reflect_batched_bwd(
                        y0, u2, v2, ids, g)
                    torch.cuda.synchronize()
                    want_l = dict.fromkeys(ops.launches(), 0)
                    want_l.update(householder_gemm_batched_bwd=1,
                                  householder_gemm_batched_dw=1,
                                  etherplus_reflect_batched_bwd=2)
                    check(ops.launches() == want_l, "bank backward wrappers "
                          f"launched {ops.launches()}")
                    route = check_dx_route(
                        ops, "householder_gemm_batched_bwd", dt, d, f, n)
                    _, gh, _ = launched(kb.householder_gemm_batched_bwd(
                        x, w, u, ids, g))
                    pdx, pgh = ref.ref_householder_gemm_batched_bwd(
                        x, w, u, ids, g)
                    pdw = ref.ref_householder_gemm_batched_dw(x, u, ids, g,
                                                              dt)
                    prx, pru, prv = ref.ref_etherplus_reflect_batched_grads(
                        x, u, v, ids, gx)
                    pox, pou, pov = ref.ref_etherplus_reflect_batched_grads(
                        y0, u2, v2, ids, g)
                    e_dx, e_dw = err(dx, pdx), err(dw, pdw)
                    e_rb = max(err(rx, prx), err(ox, pox), key=lambda e: e[1])
                    fr_hh = max(frob(du, ref.bank_grad(u, ids, pgh)),
                                frob(gh, pgh))
                    fr_rb = max(frob(p, q) for p, q in (
                        (ru, pru), (rv, prv), (ou, pou), (ov, pov)))
                    zero = all(torch.equal(
                        gr.flatten(1).abs().amax(1).cpu() > 0, touched)
                        for gr in (du, ru, rv, ou, ov))
                    what = f"{dtype} B={b} S={s} d={d} f={f} n={n}"
                    check(e_dx[1] <= TOL[dtype] and e_dw[1] <= TOL[dtype]
                          and e_rb[1] <= TOL[dtype]
                          and max(fr_hh, fr_rb) <= DU_TOL,
                          f"bank backward kernels disagree with their plain "
                          f"versions at {what}: dx {e_dx[1]:.3e}, dw "
                          f"{e_dw[1]:.3e}, reflect dx {e_rb[1]:.3e} (tol "
                          f"{TOL[dtype]:g}); du/ĝ {fr_hh:.3e}, du/dv "
                          f"{fr_rb:.3e} (tol {DU_TOL:g})")
                    check(zero, f"bank gradient rows at {what}: a named "
                          f"tenant's row is zero or an untouched one is not")
                    bank_rows = 4 * d * len(named)          # û rows read
                    dx_b = bound((2 * m * d + d * f + m * f) * es + 4 * b
                                 + bank_rows + 4 * a_n * d,
                                 2 * m * d * f + 8 * m * d, dtype)
                    dw_b = bound((m * d + m * f + d * f) * es + 4 * b
                                 + bank_rows, 2 * m * d * f + 4 * m * d,
                                 dtype)
                    rb_b = bound(3 * m * (d + f) * es + 8 * b
                                 + 8 * (d + f) * len(named)
                                 + 8 * a_n * (d + f), 20 * m * (d + f),
                                 dtype)
                    add(dict(common, kernel="householder_gemm_batched_bwd",
                             n=n, route=route,
                             epilogue=dx_epilogue(route, n, d),
                             max_abs_err=max(
                                 e_dx[0], (du - ref.bank_grad(u, ids, pgh))
                                 .abs().max().item()),
                             rel_err=e_dx[1], tol=TOL[dtype],
                             du_rel_frob=fr_hh,
                             ms=timed_ms(torch, [
                                 lambda: kb.householder_gemm_batched_bwd(
                                     x, w, u, ids, g)]),
                             plain_ms=timed_ms(torch, [
                                 lambda: ref.ref_householder_gemm_batched_grads(
                                     x, w, u, ids, g, need_dw=False)]),
                             matmul_ms=mm_dx, bound_ms=dx_b[0],
                             bound_by=dx_b[1]))
                    add(dict(common, kernel="householder_gemm_batched_dw",
                             n=n, max_abs_err=e_dw[0], rel_err=e_dw[1],
                             tol=TOL[dtype], du_rel_frob=0.0,
                             ms=timed_ms(torch, [
                                 lambda: kb.householder_gemm_batched_dw(
                                     x, u, ids, g)]),
                             plain_ms=timed_ms(torch, [
                                 lambda: ref.ref_householder_gemm_batched_dw(
                                     x, u, ids, g, dt)]),
                             matmul_ms=mm_dw, bound_ms=dw_b[0],
                             bound_by=dw_b[1]))
                    add(dict(common, kernel="etherplus_reflect_batched_bwd",
                             n=n, max_abs_err=e_rb[0], rel_err=e_rb[1],
                             tol=TOL[dtype], du_rel_frob=fr_rb,
                             ms=timed_ms(torch, [lambda: (
                                 kb.etherplus_reflect_batched_bwd(
                                     x, u, v, ids, gx),
                                 kb.etherplus_reflect_batched_bwd(
                                     y0, u2, v2, ids, g))]),
                             plain_ms=timed_ms(torch, [lambda: (
                                 ref.ref_etherplus_reflect_batched_grads(
                                     x, u, v, ids, gx),
                                 ref.ref_etherplus_reflect_batched_grads(
                                     y0, u2, v2, ids, g))]),
                             matmul_ms=mm_dx, bound_ms=rb_b[0],
                             bound_by=rb_b[1]))
                    del dx, dw, du, rx, ru, rv, ox, ou, ov
                # DeLoRA's and HyperAdapt's compositions, no dW (PEFT)
                for kernel, run, plain, n_launch, mm, bnd in (
                        ("delora_gemm_batched_bwd",
                         lambda: ops.delora_gemm_batched_bwd(
                             x, w, ab, bb, sb, ids, g, need_dw=False),
                         lambda: ref.ref_delora_gemm_batched_bwd(
                             x, w, ab, bb, sb, ids, g, need_dw=False),
                         {"delora_gemm_batched": 1}, mm_dx,
                         bound((2 * m * d + d * f + m * f) * es
                               + 8 * METHOD_RANK * (d + f) * len(named)
                               + (8 * METHOD_RANK * (d + f)
                                  + 2 * METHOD_RANK * es) * a_n,
                               2 * m * d * f
                               + 6 * m * METHOD_RANK * (d + f), dtype)),
                        ("hyperadapt_gemm_batched_bwd",
                         lambda: ops.hyperadapt_gemm_batched_bwd(
                             x, w, rb, cb, ids, g, need_dw=False),
                         lambda: ref.ref_hyperadapt_gemm_batched_bwd(
                             x, w, rb, cb, ids, g, need_dw=False),
                         {"hyperadapt_gemm_batched": 2},
                         mm_dx + timed_ms(torch, [
                             lambda: torch.matmul(x, w)]),
                         bound((2 * m * d + d * f + m * f) * es
                               + 4 * (d + f) * len(named)
                               + 8 * (d + f) * a_n,
                               4 * m * d * f + 4 * m * d + 3 * m * f,
                               dtype))):
                    ops.reset_launches()
                    got = run()
                    torch.cuda.synchronize()
                    want_l = {**dict.fromkeys(ops.launches(), 0), **n_launch}
                    check(ops.launches() == want_l,
                          f"{kernel} launched {ops.launches()}")
                    want = plain()
                    e = [err(p, q) for p, q in zip(got, want)
                         if q is not None]
                    rel = max(x for _, x in e)
                    check(rel <= METHOD_TOL[dtype], f"{kernel} disagrees "
                          f"with its plain version at {dtype} B={b} S={s} "
                          f"d={d} f={f}: {rel:.3e} > {METHOD_TOL[dtype]:g}")
                    # z's and y0's route, or dx's, and each route forced
                    fwd, rule, all_routes = {
                        "hyperadapt_gemm_batched_bwd": (
                            "hyperadapt_gemm_batched", "hyperadapt_route",
                            kb.HA_ROUTES),
                        "delora_gemm_batched_bwd": (
                            "delora_gemm_batched", "delora_route",
                            kb.DL_ROUTES)}[kernel]
                    extra = {"route": routed(ops, fwd), "route_ms": {}}
                    for on in all_routes if dtype == "bfloat16" else ():
                        with forced_route(kb, rule, on):
                            forced = max(err(p, q)[1] for p, q in zip(
                                run(), want) if q is not None)
                            check(forced <= METHOD_TOL[dtype],
                                  f"{kernel} on {on} disagrees with its "
                                  f"plain version: {forced:.3e}")
                            extra["route_ms"][on] = timed_ms(torch, [run])
                    add(dict(common, kernel=kernel, n=None, r=METHOD_RANK,
                             max_abs_err=max(x for x, _ in e), rel_err=rel,
                             tol=METHOD_TOL[dtype], du_rel_frob=0.0,
                             ms=timed_ms(torch, [run]),
                             plain_ms=timed_ms(torch, [plain]),
                             matmul_ms=mm, bound_ms=bnd[0],
                             bound_by=bnd[1], **extra))
                del x, g, gx, y0
            del w
    torch.cuda.synchronize()
    return rows


def merge_bwd_rows(torch, ops, ref, kmb):
    """Phase 2, weight mode: merge_left_bwd (rank 1 and 2, with and
    without dW) and merge_right_bwd (ETHER+'s output side, n_out =
    resolve_blocks(n, f): db_out 10 to 320 at smollm-360m's linears, n ∈
    {8, 32}) through their wrappers against their plain versions, on
    phase 2's linears with v
    drawn apart from u, then timed through their launchers (``kmb``)
    beside their plain versions, rotating (W, G) pairs past the L2.  The
    left kernel keeps its strips of W and G in shared memory up to db 160
    in f32, 320 in bf16, and re-reads them past that: smollm-360m's
    down_proj at n = 8 (db 320) in f32 takes the re-read branch (the card
    tests take it at db 1,376 too)."""
    from repro_torch.core.transforms import resolve_blocks
    print("== phase 2: merge backward kernels against their plain versions",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def errors(got, want, dtype, what):
        """max abs error over every output; the normalised max error of
        each, held to TOL[dtype]; du/dv also by relative Frobenius, held
        to DU_TOL."""
        e = [(a.float() - b.float()).abs().max().item()
             for a, b in zip(got, want) if b is not None]
        rel = [x / b.float().abs().max().item()
               for x, b in zip(e, [b for b in want if b is not None])]
        fr = [frob(a, b) for a, b in zip(got[1:], want[1:])]
        check(max(rel) <= TOL[dtype] and max(fr) <= DU_TOL,
              f"{what} disagrees with its plain version: {rel} (tol "
              f"{TOL[dtype]:g}), du/dv {fr} (tol {DU_TOL:g})")
        return max(e), max(rel), max(fr)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for arch, shapes in LINEARS.items():
            for d, f in shapes:
                pairs = [((randn(d, f) / d ** .5).to(dt), randn(d, f).to(dt))
                         for _ in range(max(1, min(256, int(
                             100e6 // (2 * d * f * es)) + 1)))]
                w, g = pairs[0]
                for n in BLOCKS:
                    n_out = resolve_blocks(n, f)
                    u, v = randn(n, d // n), randn(n, d // n)
                    u2, v2 = randn(n_out, f // n_out), randn(n_out,
                                                             f // n_out)
                    common = dict(arch=arch, dtype=dtype, t=None, d=d, f=f,
                                  n=n, tol=TOL[dtype], matmul_ms=None)
                    for rank in (1, 2):
                        vv = v if rank == 2 else None
                        for need_dw in (False, True):
                            ops.reset_launches()
                            got = ops.merge_left_bwd(w, u, g, vv,
                                                     need_dw=need_dw)
                            torch.cuda.synchronize()
                            check(ops.launches()["merge_left_bwd"] == 1,
                                  f"merge_left_bwd launched {ops.launches()}")
                            err, rel, fr = errors(
                                got, ref.ref_merge_left_bwd(
                                    w, u, g, vv, need_dw=need_dw), dtype,
                                f"merge_left_bwd r{rank} {dtype} d={d} f={f}"
                                f" n={n} need_dw={need_dw}")
                            b_ms, b_by = bound(
                                (2 + need_dw) * d * f * es + 8 * rank * d,
                                10 * rank * d * f, dtype)
                            rows.append(dict(
                                common, kernel="merge_left_bwd", rank=rank,
                                need_dw=need_dw, db=d // n, max_abs_err=err,
                                rel_err=rel, du_rel_frob=fr, bound_ms=b_ms,
                                bound_by=b_by,
                                ms=timed_ms(torch, [
                                    lambda w=w, g=g: kmb.launch_left(
                                        w, u, g, vv, need_dw)
                                    for w, g in pairs]),
                                plain_ms=timed_ms(torch, [
                                    lambda w=w, g=g: ref.ref_merge_left_bwd(
                                        w, u, g, vv, need_dw=need_dw)
                                    for w, g in pairs])))
                    ops.reset_launches()
                    got = ops.merge_right_bwd(w, u2, v2, g)
                    torch.cuda.synchronize()
                    check(ops.launches()["merge_right_bwd"] == 1,
                          f"merge_right_bwd launched {ops.launches()}")
                    err, rel, fr = errors(
                        got, ref.ref_etherplus_reflect_bwd(w, u2, v2, g),
                        dtype,
                        f"merge_right_bwd {dtype} d={d} f={f} n_out={n_out}")
                    b_ms, b_by = bound(3 * d * f * es + 16 * f, 20 * d * f,
                                       dtype)
                    rows.append(dict(
                        common, kernel="merge_right_bwd", rank=2,
                        need_dw=True, db=f // n_out, max_abs_err=err,
                        rel_err=rel, du_rel_frob=fr, bound_ms=b_ms,
                        bound_by=b_by,
                        ms=timed_ms(torch, [
                            lambda w=w, g=g: kmb.launch_right(w, u2, v2, g)
                            for w, g in pairs]),
                        plain_ms=timed_ms(torch, [
                            lambda w=w, g=g: ref.ref_etherplus_reflect_bwd(
                                w, u2, v2, g) for w, g in pairs])))
                    for r in rows[-5:]:
                        print("  {kernel:15s} r{rank} dW={need_dw:d} "
                              "{arch:11s} {dtype:8s} d={d:5d} f={f:5d} "
                              "db={db:4d}  err {rel_err:.2e} (tol {tol:g}) "
                              "du {du_rel_frob:.2e}  {ms:.4f} ms  plain "
                              "{plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                              "({bound_by})".format(**r), flush=True)
                del pairs, w, g
    torch.cuda.synchronize()
    return rows


def ssd_kernel_rows(torch, ops, ref):
    """Phase 2's SSD rows: ``ssd_chunk`` against ``ref_ssd_chunk`` on the
    same card tensors at mamba2-1.3b's scan (SSD_SHAPE) for each S of
    SSD_SEQS, padded to a chunk multiple as ``ssd_chunked`` pads; a in the
    model's range (−softplus of N(0, 1)).  Each output to TOL (f32:
    both compute in float32; the kernel takes the chunk's cumsum as a warp
    scan); the kernel and its plain version timed (CUDA events, warmed
    up); the bound from the bytes (each input read once, each output
    written once) and the operations the causal triangle needs: the
    scores c_i·b_j once per group and chunk, from bf16 operands (the
    bf16 rate), the weighted sum over xv and the state once per head and
    chunk, in float32."""
    print("== phase 2: the SSD kernel against its plain version", flush=True)
    k = SSD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []

    def held(got, want, name):
        if want.abs().max().item() == 0:    # exp(cum_L) underflows at L = 256
            check(torch.equal(got, want), f"ssd_chunk {name} is not 0 where "
                  f"its plain version underflows to 0")
            return 0.0, 0.0
        return compare(got, want, "float32", f"ssd_chunk {name}")
    for seq in SSD_SEQS:
        L = min(k["chunk"], seq)
        s = -(-seq // L) * L
        nc = s // L

        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        xv = draw(k["b"], s, k["h"], k["p"])
        a = -torch.nn.functional.softplus(draw(k["b"], s, k["h"]))
        bb = (0.5 * draw(k["b"], s, k["g"], k["n"])).bfloat16()
        cc = (0.5 * draw(k["b"], s, k["g"], k["n"])).bfloat16()
        got = ops.ssd_chunk(xv, a, bb, cc, L)
        want = ref.ref_ssd_chunk(xv, a, bb, cc, L)
        errs = [held(g, w, name) for g, w, name in zip(
            got, want, ("y_intra", "states", "decays"))]
        del got, want
        bh = k["b"] * k["h"]
        nbytes = (4 * (xv.numel() + a.numel()) + 2 * (bb.numel()
                                                      + cc.numel())
                  + 4 * (xv.numel() + bh * nc * k["n"] * k["p"] + bh * nc))
        flops = {"float32": bh * nc * (L * (L + 1) * k["p"]
                                       + 2 * L * k["n"] * k["p"]),
                 "bfloat16": k["b"] * k["g"] * nc * L * (L + 1) * k["n"]}
        b_ms, b_by = bound(nbytes, flops)
        rows.append(dict(
            kernel="ssd_chunk", arch=MAMBA_ARCH, dtype="float32", t=seq,
            s_padded=s, **dict(k, chunk=L), max_abs_err=max(e for e, _ in errs),
            rel_err=max(r for _, r in errs), tol=TOL["float32"],
            ms=timed_ms(torch, [lambda: ops.ssd_chunk(xv, a, bb, cc, L)]),
            plain_ms=timed_ms(torch, [
                lambda: ref.ref_ssd_chunk(xv, a, bb, cc, L)]),
            matmul_ms=None, library_ms=None, bound_ms=b_ms, bound_by=b_by,
            gflop=sum(flops.values()) / 1e9, mbytes=nbytes / 1e6))
        print("  ssd_chunk        {arch} B·H={bh} S={t} (padded {s_padded}, "
              "L={chunk}) P={p} N={n}  err {rel_err:.2e} (tol {tol:g})  "
              "{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
              "({bound_by}: {gflop:.2f} GFLOP, {mbytes:.1f} MB)".format(
                  bh=bh, **rows[-1]), flush=True)
        del xv, a, bb, cc
    torch.cuda.synchronize()
    return rows


def flash_pairs(s, t, q_offset, window):
    """The (query, key) pairs a causal attention of S queries at
    ``q_offset``.. against T keys attends to (``window``: the last
    ``window`` positions only): the work this row's data needs."""
    pairs = 0
    for i in range(s):
        qpos = q_offset + i
        lo = 0 if window is None else max(0, qpos - window + 1)
        pairs += max(0, min(t - 1, qpos) - lo + 1)
    return pairs


def flash_keys(s, t, q_offset, window):
    """The keys some query row of that attention can see (the rows i at
    ``q_offset`` + i see [qpos − ``window`` + 1, qpos], so together
    [q_offset − window + 1, q_offset + S)): the K and V rows it must
    read."""
    lo = 0 if window is None else max(0, q_offset - window + 1)
    return max(0, min(t, q_offset + s) - lo)


def flash_mask(torch, s, t, q_offset, window):
    """The (S, T) boolean mask of those pairs (True: attend), on the card."""
    qpos = q_offset + torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(t, device="cuda")[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_kernel_rows(torch, ops, ref):
    """Phase 2's flash rows: ``flash_attention`` against
    ``ref_flash_attention`` on the same card tensors at each of FLASH_ROWS,
    bf16 and f32 (f32 to FLASH_TOL's normalised max error, bf16 to its
    relative Frobenius norm: one rounding of an f32 result); a row with no
    valid key must be exact zeros where the plain version's is.  Timed:
    the kernel, its plain version and, as ``library_ms``,
    ``scaled_dot_product_attention`` on the same q, k, v (``enable_gqa``;
    an explicit boolean mask unless the queries start at 0 on a square,
    windowless causal mask), a yardstick nothing in the port calls.  The
    bound: q and the K and V rows some query can see (flash_keys) read
    once and the output written once, and the 4·D FLOP of QKᵀ and PV for
    each attended pair (flash_pairs) at the dtype's peak."""
    print("== phase 2: the flash attention kernel against its plain version",
          flush=True)
    from repro_torch.kernels import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for name, b, h, hkv, s, t, d, off, win in FLASH_ROWS:
            q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dt)
            k = torch.randn(b, hkv, t, d, generator=gen, device="cuda").to(dt)
            v = torch.randn(b, hkv, t, d, generator=gen, device="cuda").to(dt)
            kw = dict(causal=True, window=win, q_offset=off)
            if name == POISONED_ROW:
                k[:, 1], v[:, 1] = float("inf"), float("inf")
            ops.reset_launches()
            got = ops.flash_attention(q, k, v, **kw)
            on = routed(ops, "flash_attention")
            want_on = fa.route(dt, d, s * (h // hkv))
            check(on == want_on, f"flash_attention {name} {dtype} launched "
                  f"on route {on}, want {want_on}")
            if name == POISONED_ROW:
                # KV head 0's query heads, against the plain version on
                # KV head 0 alone
                rep = h // hkv
                got = got[:, :rep]
                want = ref.ref_flash_attention(q[:, :rep], k[:, :1],
                                               v[:, :1], **kw)
            else:
                want = ref.ref_flash_attention(q, k, v, **kw)
            err = (got.float() - want.float()).abs().max().item()
            if dtype == "float32":
                rel = err / want.float().abs().max().item()
            else:
                rel = frob(got.float(), want.float())
            check(rel <= FLASH_TOL[dtype], f"flash_attention {name} {dtype} "
                  f"disagrees with its plain version: {rel:.3e} > "
                  f"{FLASH_TOL[dtype]:g}")
            empty = (want == 0).all(dim=-1)
            n_empty = int(empty.sum().item())
            check(bool((got[empty] == 0).all()) and bool(
                torch.isfinite(got).all()), f"flash_attention {name}: a row "
                f"with no valid key is not exact zeros")
            if name == "fully masked rows":
                check(n_empty > 0, "the fully masked row has no empty row")
            del got, want
            square = off == 0 and win is None and s == t
            mask = None if square else flash_mask(torch, s, t, off, win)
            try:
                sdpa(q, k, v, attn_mask=mask, is_causal=square,
                     enable_gqa=True)
                library_ms = timed_ms(torch, [lambda: sdpa(
                    q, k, v, attn_mask=mask, is_causal=square,
                    enable_gqa=True)])
            except TypeError:               # a torch without enable_gqa
                library_ms = None
            pairs = flash_pairs(s, t, off, win)
            flops = 4 * d * pairs * b * h
            keys = flash_keys(s, t, off, win)
            nbytes = es * (2 * b * h * s * d + 2 * b * hkv * keys * d)
            b_ms, b_by = bound(nbytes, flops, dtype)
            rows.append(dict(
                kernel="flash_attention", arch=name, dtype=dtype, b=b, h=h,
                hkv=hkv, s=s, t=t, d=d, q_offset=off, window=win, route=on,
                empty_rows=n_empty, max_abs_err=err, rel_err=rel,
                tol=FLASH_TOL[dtype],
                ms=timed_ms(torch, [lambda: ops.flash_attention(q, k, v,
                                                                **kw)]),
                plain_ms=timed_ms(torch, [
                    lambda: ref.ref_flash_attention(q, k, v, **kw)]),
                library_ms=library_ms, matmul_ms=None, bound_ms=b_ms,
                bound_by=b_by, gflop=flops / 1e9, mbytes=nbytes / 1e6))
            print("  flash_attention  {arch:20s} {dtype:8s} B={b} H={h}/{hkv} "
                  "S={s} T={t} D={d} q_offset={q_offset} window={window}  "
                  "route {route:6s}  "
                  "err {rel_err:.2e} (tol {tol:g})  {ms:.4f} ms  plain "
                  "{plain_ms:.4f} ms  sdpa {lib}  bound {bound_ms:.4f} ms "
                  "({bound_by}: {gflop:.2f} GFLOP, {mbytes:.1f} MB)".format(
                      lib="n/a" if library_ms is None
                      else f"{library_ms:.4f} ms", **rows[-1]), flush=True)
            del q, k, v, mask
    torch.cuda.synchronize()
    return rows


def reflect_kernel_rows(torch, ops, ref, ker, kerb):
    """Phase 2, the registry's standalone reflections: ether_reflect and
    ether_reflect_bwd at REFLECT_ROWS rows of the linears' input widths
    (smollm-360m's at n ∈ BLOCKS, Llama-2-7B's at the train rows: db 512
    and 1,376 at n = 8), and ether_reflect_batched and
    ether_reflect_batched_bwd at smollm-360m's widths through a
    BANK_TENANTS-tenant bank at BANK_BWD_ROWS, ids BANK_IDS repeated to B,
    bf16 and f32, through their wrappers against their plain versions: y
    and dx to TOL, du and du_bank to DU_TOL (relative Frobenius), the
    tenants no id names exactly zero.  A reflection acts on d alone, so a
    (kernel, dtype, rows, d, n) is timed once, through its launcher (``ker``,
    ``kerb``) beside its plain version, and the rows of the linears that
    share d carry that time.  The bound counts x (and G) read and y (dx)
    written once, u and the bank's named rows read, the f32 operations at
    the f32 rate.  Operands from a generator of their own."""
    print("== phase 2: the standalone reflections against their plain "
          f"versions (A={BANK_TENANTS}, ids {BANK_IDS})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows, timed = [], {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def err(got, want):
        e = (got.float() - want.float()).abs().max().item()
        return e, e / want.float().abs().max().item()

    def once(key, fn):
        if key not in timed:
            timed[key] = timed_ms(torch, [fn])
        return timed[key]

    def add(row):
        rows.append(row)
        print("  {kernel:25s} {arch:11s} {dtype:8s} T={t:4d} d={d:5d} "
              "f={f:5d} n={n:2d}  err {rel_err:.2e} (tol {tol:g})  du "
              "{du_rel_frob:.2e}  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              "bound {bound_ms:.4f} ms ({bound_by})".format(**row),
              flush=True)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for arch, shapes in {**LINEARS, **WIDE_LINEARS}.items():
            for d, f in shapes:
                for n in BLOCKS:
                    u = randn(n, d // n)
                    for t in REFLECT_ROWS if arch == ARCH else BWD_ROWS[:1]:
                        x, g = randn(t, d).to(dt), randn(t, d).to(dt)
                        ops.reset_launches()
                        y = ops.ether_reflect(x, u)
                        dx, du = ops.ether_reflect_bwd(x, u, g)
                        torch.cuda.synchronize()
                        check(ops.launches() == {
                            **dict.fromkeys(ops.launches(), 0),
                            "ether_reflect": 1, "ether_reflect_bwd": 1},
                              f"reflection wrappers launched "
                              f"{ops.launches()}")
                        pdx, pdu = ref.ref_ether_reflect_bwd(x, u, g)
                        e_y = err(y, ref.ref_ether_reflect(x, u))
                        e_dx, fr = err(dx, pdx), frob(du, pdu)
                        what = f"{arch} {dtype} T={t} d={d} n={n}"
                        check(max(e_y[1], e_dx[1]) <= TOL[dtype]
                              and fr <= DU_TOL,
                              f"the reflection kernels disagree with their "
                              f"plain versions at {what}: y {e_y[1]:.3e}, dx "
                              f"{e_dx[1]:.3e} (tol {TOL[dtype]:g}), du "
                              f"{fr:.3e} (tol {DU_TOL:g})")
                        common = dict(arch=arch, dtype=dtype, t=t, d=d, f=f,
                                      n=n, tol=TOL[dtype], matmul_ms=None,
                                      library_ms=None)
                        key = (dtype, t, d, n)
                        b_ms, b_by = bound(2 * t * d * es + 4 * d,
                                           {"float32": 6 * t * d})
                        add(dict(common, kernel="ether_reflect",
                                 max_abs_err=e_y[0], rel_err=e_y[1],
                                 du_rel_frob=0.0, bound_ms=b_ms,
                                 bound_by=b_by,
                                 ms=once(("fwd",) + key,
                                         lambda: ker.launch(x, u)),
                                 plain_ms=once(("fwd plain",) + key,
                                               lambda: ref.ref_ether_reflect(
                                                   x, u))))
                        b_ms, b_by = bound(3 * t * d * es + 8 * d,
                                           {"float32": 12 * t * d})
                        add(dict(common, kernel="ether_reflect_bwd",
                                 max_abs_err=max(e_dx[0], (du - pdu).abs()
                                                 .max().item()),
                                 rel_err=e_dx[1], du_rel_frob=fr,
                                 bound_ms=b_ms, bound_by=b_by,
                                 ms=once(("bwd",) + key,
                                         lambda: kerb.launch(x, u, g)),
                                 plain_ms=once(
                                     ("bwd plain",) + key,
                                     lambda: ref.ref_ether_reflect_bwd(
                                         x, u, g))))
                        del x, g, y, dx, du
        a_n = BANK_TENANTS
        for d, f in LINEARS[ARCH]:
            for n in BLOCKS:
                ub = randn(a_n, n, d // n)
                for b, s in BANK_BWD_ROWS:
                    ids = torch.tensor(BANK_IDS * (b // len(BANK_IDS))
                                       + BANK_IDS[:b % len(BANK_IDS)],
                                       dtype=torch.int32, device="cuda")
                    named = sorted(set(ids.tolist()))
                    x, g = randn(b, s, d).to(dt), randn(b, s, d).to(dt)
                    ops.reset_launches()
                    y = ops.ether_reflect_batched(x, ub, ids)
                    dx, du = ops.ether_reflect_batched_bwd(x, ub, ids, g)
                    torch.cuda.synchronize()
                    check(ops.launches() == {
                        **dict.fromkeys(ops.launches(), 0),
                        "ether_reflect_batched": 1,
                        "ether_reflect_batched_bwd": 1},
                          f"bank reflection wrappers launched "
                          f"{ops.launches()}")
                    pdx, pdu = ref.ref_ether_reflect_batched_bwd(x, ub, ids,
                                                                 g)
                    e_y = err(y, ref.ref_ether_reflect_batched(x, ub, ids))
                    e_dx, fr = err(dx, pdx), frob(du, pdu)
                    touched = torch.zeros(a_n, dtype=torch.bool)
                    touched[named] = True
                    what = f"{dtype} B={b} S={s} d={d} n={n}"
                    check(max(e_y[1], e_dx[1]) <= TOL[dtype]
                          and fr <= DU_TOL,
                          f"the bank reflection kernels disagree with their "
                          f"plain versions at {what}: y {e_y[1]:.3e}, dx "
                          f"{e_dx[1]:.3e} (tol {TOL[dtype]:g}), du {fr:.3e} "
                          f"(tol {DU_TOL:g})")
                    check(torch.equal(du.flatten(1).abs().amax(1).cpu() > 0,
                                      touched),
                          f"bank reflection gradient rows at {what}: a named "
                          f"tenant's row is zero or an untouched one is not")
                    m = b * s
                    common = dict(arch=ARCH, dtype=dtype, b=b, s=s, t=m, d=d,
                                  f=f, n=n, tenants=a_n, tol=TOL[dtype],
                                  matmul_ms=None, library_ms=None)
                    key = (dtype, b, s, d, n)
                    b_ms, b_by = bound(2 * m * d * es + 4 * b
                                       + 4 * d * len(named),
                                       {"float32": 6 * m * d})
                    add(dict(common, kernel="ether_reflect_batched",
                             max_abs_err=e_y[0], rel_err=e_y[1],
                             du_rel_frob=0.0, bound_ms=b_ms, bound_by=b_by,
                             ms=once(("bank",) + key,
                                     lambda: ker.launch_batched(x, ub, ids)),
                             plain_ms=once(
                                 ("bank plain",) + key,
                                 lambda: ref.ref_ether_reflect_batched(
                                     x, ub, ids))))
                    b_ms, b_by = bound(3 * m * d * es + 4 * b
                                       + 4 * d * len(named) + 4 * a_n * d,
                                       {"float32": 12 * m * d})
                    add(dict(common, kernel="ether_reflect_batched_bwd",
                             max_abs_err=max(e_dx[0], (du - pdu).abs().max()
                                             .item()),
                             rel_err=e_dx[1], du_rel_frob=fr, bound_ms=b_ms,
                             bound_by=b_by,
                             ms=once(("bank bwd",) + key,
                                     lambda: kerb.launch_batched(x, ub, ids,
                                                                 g)),
                             plain_ms=once(
                                 ("bank bwd plain",) + key,
                                 lambda: ref.ref_ether_reflect_batched_bwd(
                                     x, ub, ids, g))))
                    del x, g, y, dx, du
    torch.cuda.synchronize()
    return rows


def layer_summary(rows, kernel, n, t, **match):
    """Sum over one smollm-360m layer's seven linears (bf16, ``n``
    blocks, ``t`` rows; None for the merges; the rows whose other keys
    equal ``match``): the kernel work of one layer of one decode step
    (n = 8, t = B) or train step (n = 32, t = B·S)."""
    pick = [r for r in rows if r["kernel"] == kernel and r["arch"] == ARCH
            and r["dtype"] == "bfloat16" and r["n"] == n and r["t"] == t
            and all(r.get(k) == v for k, v in match.items())]
    out = {k: 0.0 for k in ("ms", "plain_ms", "bound_ms", "matmul_ms",
                            "library_ms")}
    by = {"bytes": 0.0, "operations": 0.0}
    for r in pick:
        mult = LAYER[(r["d"], r["f"])]
        for k in out:
            out[k] += mult * (r.get(k) or 0.0)
        by[r["bound_by"]] += mult * r["bound_ms"]
    check(sum(LAYER.values()) == sum(LAYER[(r["d"], r["f"])] for r in pick),
          f"{kernel}: missing main-path shapes in the kernel table")
    out["max_abs_err"] = max(r["max_abs_err"] for r in pick)
    out["bound_by"] = max(by, key=by.get)
    return out


def counted(torch, execute, ops, run):
    """``run()``, a main path, with every count set to 0 just before it;
    its result with the path's own dispatch counters, kernel launches and
    peak memory read just after it."""
    execute.reset_counters()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    r = run()
    r["counters"], r["launches"] = execute.counters(), ops.launches()
    r["routes"] = ops.routes()
    r["flash_routes"] = ops.routes("flash_attention")
    r["ep_routes"] = ops.routes("etherplus_gemm")
    r["bank_routes"] = ops.routes("householder_gemm_batched")
    r["ha_routes"] = ops.routes("hyperadapt_gemm_batched")
    r["hg_routes"] = ops.routes("hyperadapt_gemm")
    r["dl_routes"] = ops.routes("delora_gemm_batched")
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return r


# the device's own work in a Chrome trace, and the host's events
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernels of csrc/flash_attention.cu, by their names in a trace: the
# routes `wgmma`, `decode` (and its combine of the splits) and `simt`
FLASH_KERNELS = ("::wg::wgmma_kernel<", "::dec::decode_kernel<",
                 "::dec::combine_kernel<", "::flash_kernel<")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the device work of the bf16 forwards of ETHER+ (etherplus_gemm) and of
# the ETHER bank (householder_gemm_batched), and of HyperAdapt, through a
# bank and with one tenant (hyperadapt_gemm_batched, hyperadapt_gemm), and
# of the DeLoRA bank (delora_gemm_batched) with their backward's GEMMs, on
# their wgmma routes in a trace, by kernel name: each name holds every
# string of one of its op's tuples.  Their prologues (proj_kernel: ETHER+'s
# rank 2, the bank's under BANK; the weight gradients that share them
# launch 0 times, as PEFT freezes W; scaled_wgmma.cuh's scale_rows_kernel,
# the bank's taking Tenants, and lowrank_h_kernel), the wgmma cores
# (hh_wgmma.cuh: rank 2, or rank 1 under BANK; scaled_wgmma.cuh's
# gemm_kernel<TN, W layout, MODE>: the bank's kColScale 1 and kPlain 0,
# the single tenant's 5 and 4, DeLoRA's kLowRank 2) and ETHER+'s scratch
# epilogue (rank2_rows_kernel on an f32 y0)
FWD_KERNELS = {
    "etherplus_gemm": (("proj_kernel<__nv_bfloat16, true",),
                       ("hhw::", "wgmma_kernel<128, 2,"),
                       ("rank2_rows_kernel<float, __nv_bfloat16",)),
    "householder_gemm_batched": (
        ("proj_kernel<__nv_bfloat16, false, true>",),
        ("hhw::", "wgmma_kernel<128, 1, true,")),
    "hyperadapt_gemm_batched": (("sw::", "scale_rows_kernel", "Tenants"),
                                ("sw::", "gemm_kernel<", ", 1>"),
                                ("sw::", "gemm_kernel<", ", 0>")),
    "hyperadapt_gemm": (("sw::", "scale_rows_kernel",
                         "__nv_bfloat16*, int, int)"),
                        ("sw::", "gemm_kernel<", ", 5>"),
                        ("sw::", "gemm_kernel<", ", 4>")),
    "delora_gemm_batched": (("sw::", "lowrank_h_kernel"),
                            ("sw::", "gemm_kernel<", ", 2>"))}


def trace_tables(events, steps):
    """Per step, from a Chrome trace's complete ("X") events: the device's
    busy ms (its kernels, copies and sets) and its busiest kernels; the
    top-level host operators -- on each thread, the host events no other
    event of that thread contains -- as ATen ops, CUDA runtime calls
    (such as the ctypes kernel launches) and others, with their CPU µs."""
    dev = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            dev[e["name"]] = dev.get(e["name"], 0.0) + e["dur"] / 1e3 / steps
    top = {"aten": [], "cuda runtime": [], "other": []}
    ends = {}                           # thread -> end of its open event
    for e in sorted((e for e in events if e.get("cat") in HOST_CATS),
                    key=lambda e: (e["pid"], e["tid"], e["ts"], -e["dur"])):
        thread = (e["pid"], e["tid"])
        if e["ts"] < ends.get(thread, -math.inf):
            continue                    # inside a top-level event
        ends[thread] = e["ts"] + e["dur"]
        name = e["name"]
        kind = ("aten" if name.startswith("aten::") else "cuda runtime"
                if name.startswith("cuda") else "other")
        top[kind].append(e["dur"])
    return {"device_busy_ms": sum(dev.values()),
            "busiest_ms": sorted(dev.items(), key=lambda r: -r[1])[:6],
            "flash_ms": sum(ms for name, ms in dev.items()
                            if any(k in name for k in FLASH_KERNELS)),
            "dxr_ms": {k: sum(ms for name, ms in dev.items() if k in name)
                       for k in DXR_KERNELS},
            "fwd_ms": {op: sum(ms for name, ms in dev.items()
                               if any(all(k in name for k in keys)
                                      for keys in pats))
                       for op, pats in FWD_KERNELS.items()},
            "top_level_ops": {k: len(v) / steps for k, v in top.items()},
            "top_level_cpu_us": {k: sum(v) / max(len(v), 1)
                                 for k, v in top.items()},
            "top_level_cpu_ms": sum(map(sum, top.values())) / 1e3 / steps}


def trace_steps(torch, run, steps):
    """torch.profiler trace of ``run()``, which runs ``steps`` steps and
    synchronises: wall ms a step under the profiler and
    :func:`trace_tables` of the trace; and the seconds the profiler's
    stop and these tables took after the run (what the trace costs the
    script).  The tables read the Chrome trace that the profiler writes
    in C++: building its Python events instead took 35-54% of a train
    phase with two traced steps (PERF.md)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()        # the profiler's start and stop
        run()                           # are left out of the wall time
        t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X"]
    return {"profiled_wall_ms": (t1 - t0) * 1e3 / steps,
            **trace_tables(events, steps),
            "processing_s": time.perf_counter() - t1}


def print_trace(name, t, unprofiled_ms):
    n_ops = sum(t["top_level_ops"].values())
    print(f"[{name}] profiled step: wall {t['profiled_wall_ms']:.2f} ms, "
          f"device busy {t['device_busy_ms']:.3f} ms (idle "
          f"{100 * (1 - t['device_busy_ms'] / t['profiled_wall_ms']):.1f}% "
          f"of the profiled wall, "
          f"{100 * (1 - t['device_busy_ms'] / unprofiled_ms):.1f}% of the "
          f"unprofiled)", flush=True)
    print(f"    host: {n_ops:.1f} top-level ops per step ("
          + ", ".join(f"{k} {n:.1f} x {t['top_level_cpu_us'][k]:.1f} us"
                      for k, n in t["top_level_ops"].items() if n)
          + f"): {t['top_level_cpu_ms']:.2f} ms CPU in them, "
          f"{100 * t['top_level_cpu_ms'] / t['profiled_wall_ms']:.1f}% "
          f"of the profiled wall")
    print("    busiest device work: " + ", ".join(
        f"{k[:48]} {ms:.3f} ms" for k, ms in t["busiest_ms"])
        + f"; the flash kernel's {t['flash_ms']:.3f} ms; the trace's "
        f"processing took {t['processing_s']:.1f} s")
    if any(t["fwd_ms"].values()):
        print("    the forwards' kernels a step: " + ", ".join(
            f"{op} {ms:.3f} ms" for op, ms in t["fwd_ms"].items()),
            flush=True)
    if any(t["dxr_ms"].values()):
        print("    the dXr backwards' kernels a step: " + ", ".join(
            f"{k.rstrip(':')} {ms:.3f} ms" for k, ms in t["dxr_ms"].items())
            + f"; {sum(t['dxr_ms'].values()):.3f} ms in all", flush=True)


def profile_decode(torch, serve, api, steps, **kw):
    """The trace of ``steps`` greedy decode steps of the model
    ``serve.build(**kw)`` makes, after as many untimed ones."""
    m = serve.build(**kw)
    return trace_decode(torch, api, steps, m["params"], m["adapters"],
                        m["tokens"], m["cfg"], m["peft"])


def trace_decode(torch, api, steps, params, adapters, tokens, cfg, peft,
                 tenant_ids=None):
    """The trace of ``steps`` greedy decode steps of one model and batch
    (``adapters`` may be a bank, with ``tenant_ids``), after as many
    untimed ones."""
    cache, logits = api.prefill(params, adapters, {"tokens": tokens}, cfg,
                                peft, tenant_ids=tenant_ids)
    cache = api.pad_cache(cache, cfg, tokens.shape[1] + 2 * steps + 1)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)

    def decode():
        nonlocal tok, cache
        for _ in range(steps):
            logits, cache = api.decode_step(params, adapters, cache, tok,
                                            cfg, peft, tenant_ids=tenant_ids)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()

    decode()
    return trace_steps(torch, decode, steps)


def decode_map_encodes(torch, api, steps, params, adapters, tokens, cfg,
                       peft, counts, tenant_ids=None):
    """The tensor maps a wgmma route encodes on the host (its map cache's
    misses, read by ``counts``: ``householder_gemm.map_counts`` or another
    library's) in the prefill and then in each of ``steps`` greedy decode
    steps of one model and batch (``adapters`` may be a bank, with
    ``tenant_ids``), [prefill, step 1, ..., step ``steps``]."""
    seen = counts()["encodes"]
    per = []

    def encoded():
        nonlocal seen
        now = counts()["encodes"]
        per.append(now - seen)
        seen = now

    cache, logits = api.prefill(params, adapters, {"tokens": tokens}, cfg,
                                peft, tenant_ids=tenant_ids)
    cache = api.pad_cache(cache, cfg, tokens.shape[1] + steps + 1)
    encoded()
    for _ in range(steps):
        logits, cache = api.decode_step(
            params, adapters, cache, logits[:, -1].argmax(dim=-1,
                                                          keepdim=True),
            cfg, peft, tenant_ids=tenant_ids)
        encoded()
    torch.cuda.synchronize()
    return per


def check_map_encodes(encodes, lookups_a_step, what):
    """A decode path's maps encoded (:func:`decode_map_encodes`), printed;
    the later half of the steps must encode none: once the first steps
    have encoded a step's maps, the cache holds them."""
    print(f"[{what}] tensor maps encoded on the host: prefill {encodes[0]}, "
          f"decode steps 1-{len(encodes) - 1} {encodes[1:]} (two lookups a "
          f"linear, {lookups_a_step} a step)", flush=True)
    half = (len(encodes) - 1) // 2 + 1
    check(not any(encodes[half:]), f"{what}: decode steps {half}-"
          f"{len(encodes) - 1} still encode tensor maps: the map cache does "
          f"not hold a step's maps")


def with_attention(want, cfg, forwards):
    """``want`` (dispatch counters, kernel launches) of a dense decoder's
    serving run with its attention added: every layer of every forward
    (each prefill and decode step) on the flash kernel."""
    n = cfg.n_layers * forwards
    return ({**want[0], "flash_attention.cuda": n},
            {**want[1], "flash_attention": n})


def served_flash_routes(torch, cfg, forwards, prompt_len, attends):
    """flash_attention's launches by route in a served bf16 run
    (``serve.generate``: two prefills of ``prompt_len`` tokens, then
    ``forwards`` − 2 decode steps), one call a layer a forward where the
    model ``attends``: the prefills on the route of a KV group's
    prompt_len · H/Hkv rows (``wgmma`` at smollm-360m's 32 · 3 and
    qwen2.5-32b's 2048 · 5), every decode step on ``decode``."""
    from repro_torch.kernels import flash_attention as fa
    want = {f"flash_attention.{r}": 0 for r in fa.ROUTES}
    if attends:
        rows = prompt_len * (cfg.n_heads // cfg.n_kv)
        first = fa.route(torch.bfloat16, cfg.hd, rows)
        want[f"flash_attention.{first}"] += 2 * cfg.n_layers
        want["flash_attention.decode"] += (forwards - 2) * cfg.n_layers
    return want


def check_flash_routes(torch, cfg, r, prompt_len, attends, what):
    want = served_flash_routes(torch, cfg, r["forwards"], prompt_len,
                               attends)
    print(f"[{what}] flash_attention routes: {r['flash_routes']}")
    check(r["flash_routes"] == want, f"{what}: flash_attention launched on "
          f"routes {r['flash_routes']}, want {want}")


def check_served(torch, cfg, runs, want, batch=B, prompt_len=P):
    """Hold each served path's counts to ``want[name]`` (dispatch
    counters, kernel launches) and its attention's routes
    (served_flash_routes), and its outputs to their shapes (``batch``
    rows); print its times."""
    for name, r in runs.items():
        print(f"[{name}] dispatch counters: {r['counters']}  kernel "
              f"launches: {r['launches']}")
        check((r["counters"], r["launches"]) == want[name],
              f"{name} path ran {r['counters']} / launched "
              f"{r['launches']}, want {want[name][0]} / {want[name][1]} "
              f"({r['forwards']} forwards, no plain version)")
        check_flash_routes(torch, cfg, r, prompt_len,
                           want[name][1].get("flash_attention", 0) > 0, name)
        check(tuple(r["logits"].shape) == (batch, 1, cfg.vocab)
              and r["logits"].dtype == torch.float32
              and bool(torch.isfinite(r["logits"]).all()),
              f"{name} logits are not finite (B, 1, V) float32")
        check(tuple(r["tokens"].shape) == (batch, GEN + 1),
              f"{name} generated {tuple(r['tokens'].shape)} tokens")
        print(f"[{name}] prefill {r['prefill_s'] * 1e3:.2f} ms  decode "
              f"{r['per_token_s'] * 1e3:.3f} ms/token  peak memory "
              f"{r['peak_gb']:.3f} GB  ({r['forwards']} forwards"
              + (f", merge {r['merge_s'] * 1e3:.1f} ms" if r["merge_s"]
                 else "") + ")")


def frob(a, b):
    return ((a - b).norm() / b.norm()).item()


def agree(a, b):
    return (a == b).float().mean().item()


def phase_serve(torch, execute, ops, serve, api):
    print(f"== phase 3: serve {ARCH} full width, ETHER n_blocks={N_BLOCKS}, "
          f"B={B} P={P} gen={GEN}", flush=True)
    kw = dict(arch=ARCH, variant="full", n_blocks=N_BLOCKS, batch=B,
              prompt_len=P, seed=0, device="cuda")
    un = counted(torch, execute, ops, lambda: serve.serve(
        backend="auto", gen=GEN, **kw))
    mg = counted(torch, execute, ops, lambda: serve.serve(
        backend="auto", gen=GEN, merged=True, **kw))

    from repro_torch.configs import get_config
    cfg = get_config(ARCH, "full")
    per_forward = 7 * cfg.n_layers
    # each path's own counts: the unmerged path runs householder_gemm on
    # every adapted linear of every forward; the merged path runs
    # ether_merge once per adapted linear; both run every layer's
    # attention of every forward on the flash kernel, and nothing else
    none = dict.fromkeys(ops.launches(), 0)
    want = {"unmerged": with_attention((
                {"householder_gemm.cuda": per_forward * un["forwards"]},
                {**none, "householder_gemm": per_forward * un["forwards"]}),
                cfg, un["forwards"]),
            "merged": with_attention((
                {"ether_merge.cuda": per_forward},
                {**none, "ether_merge": per_forward}), cfg, mg["forwards"])}
    check_served(torch, cfg, {"unmerged": un, "merged": mg}, want)
    check_routes(un, served_routes(ops, per_forward, un["forwards"], B * P,
                                   B), "unmerged")
    merged_err = frob(mg["logits"], un["logits"])
    check(merged_err <= SERVE_TOL, f"merged vs unmerged logits "
          f"{merged_err:.3e} > {SERVE_TOL:g}")
    print(f"merged vs unmerged: logits rel. Frobenius {merged_err:.3e} "
          f"(tol {SERVE_TOL:g}), greedy tokens agree "
          f"{agree(mg['tokens'], un['tokens']) * 100:.1f}%")

    # reference: the same model through the plain versions on the card,
    # outside the counted main-path run
    ref_run = serve.serve(backend="torch", **{**kw, "gen": 4})
    plain_err = frob(un["logits"], ref_run["logits"])
    check(plain_err <= SERVE_TOL, f"kernels vs plain path logits "
          f"{plain_err:.3e} > {SERVE_TOL:g}")
    print(f"kernels vs plain path: logits rel. Frobenius {plain_err:.3e} "
          f"(tol {SERVE_TOL:g}), greedy tokens agree "
          f"{agree(un['tokens'][:, :5], ref_run['tokens']) * 100:.1f}%")

    # the decode step under torch.profiler, outside the counted runs
    traces = {}
    for name, r in (("unmerged", un), ("merged", mg)):
        t = traces[name] = profile_decode(torch, serve, api, TRACE_STEPS,
                                          merged=r["merge_s"] is not None,
                                          **kw)
        print_trace(name, t, r["per_token_s"] * 1e3)

    # the wgmma routes' tensor-map cache on the decode path, outside the
    # counted runs: a step's weights and (from the caching allocator) its
    # activations come back at the same addresses, so once the first step
    # has encoded its maps the cache should hold them
    from repro_torch.kernels import householder_gemm as hh
    m = serve.build(**kw)
    encodes = decode_map_encodes(torch, api, GEN, m["params"],
                                 m["adapters"], m["tokens"], m["cfg"],
                                 m["peft"], hh.map_counts)
    del m
    check_map_encodes(encodes, 2 * per_forward, "householder_gemm")

    w_bytes = 2 * cfg.n_layers * sum(m * d * f for (d, f), m in LAYER.items())
    print(f"decode-step bound from reading the adapted weights: "
          f"{w_bytes / 1e6:.0f} MB / 3.35 TB/s = "
          f"{w_bytes / HBM_BYTES_S * 1e3:.3f} ms")
    return dict(merged_vs_unmerged=merged_err, kernels_vs_plain=plain_err,
                token_agreement=agree(mg["tokens"], un["tokens"]),
                weights_bytes=w_bytes, decode_map_encodes=encodes,
                **{f"{name}_{k}": r[k] for name, r in
                   (("unmerged", un), ("merged", mg))
                   for k in ("prefill_s", "per_token_s", "peak_gb",
                             "forwards", "merge_s", "counters", "launches",
                             "routes", "flash_routes")},
                traces=traces)


def off_init(torch, adapters, moves, seed):
    """``adapters`` with the leaves named in ``moves`` (leaf name →
    function of (leaf, unit normal noise)) moved off the method's init,
    the noise from a generator seeded with ``seed``."""
    from repro_torch.common.pytree import map_with_paths
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def move(path, t):
        fn = moves.get(path.rsplit("/", 1)[-1])
        if fn is None:
            return t
        return fn(t, torch.randn(t.shape, generator=gen, device=t.device,
                                 dtype=t.dtype))
    return map_with_paths(move, adapters)


def phase_serve_method(torch, execute, ops, serve, api, phase, method):
    """Phases 5 (``method`` "etherplus", two-sided), 7 ("delora") and 9
    ("hyperadapt"): phase 3's model and requests with the method's
    adapters moved off its init (ETHER+'s v1/v2 drawn apart from u1/u2,
    DeLoRA's b and λ, HyperAdapt's r and c about 1), through
    ``serve.generate`` unmerged and after ``merge_params``, each with
    every count set to 0 just before it, then traces the decode step of
    each.  See the module docstring."""
    import dataclasses

    from repro_torch.core.peft import merge_params
    moves = {"etherplus": {k: lambda t, z: t + EP_SPREAD * z
                           for k in ("v1", "v2")},
             "delora": {"b": lambda t, z: z,
                        "lam": lambda t, z: DELORA_LAM
                        + DELORA_LAM_SPREAD * z},
             "hyperadapt": {"r": lambda t, z: 1 + HA_SPREAD * z,
                            "c": lambda t, z: 1 + HA_SPREAD * z}}[method]
    label = {"etherplus": f"ETHER+ two-sided n_blocks={N_BLOCKS}, v drawn "
                          f"apart from u (spread {EP_SPREAD:g})",
             "delora": f"DeLoRA rank {METHOD_RANK}, b ~ N(0, 1), λ ~ "
                       f"{DELORA_LAM:g} + {DELORA_LAM_SPREAD:g}·N(0, 1)",
             "hyperadapt": f"HyperAdapt, r and c ~ 1 + {HA_SPREAD:g}·"
                           f"N(0, 1)"}[method]
    print(f"== phase {phase}: serve {ARCH} full width, {label}, B={B} P={P} "
          f"gen={GEN}", flush=True)
    kw = dict(arch=ARCH, variant="full", method=method, n_blocks=N_BLOCKS,
              rank=METHOD_RANK, batch=B, prompt_len=P, seed=0, device="cuda")
    m = serve.build(**kw)
    cfg, peft, params, tokens = (m[k] for k in ("cfg", "peft", "params",
                                                "tokens"))
    adapters = off_init(torch, m["adapters"], moves, phase)

    def merged():
        t0 = time.perf_counter()
        mp = merge_params(params, adapters, peft)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        return dict(serve.generate(mp, None, tokens, cfg, None, GEN),
                    merge_s=merge_s)

    un = counted(torch, execute, ops, lambda: dict(serve.generate(
        params, adapters, tokens, cfg, peft, GEN), merge_s=None))
    mg = counted(torch, execute, ops, merged)
    per_forward = 7 * cfg.n_layers
    none = dict.fromkeys(ops.launches(), 0)
    # ETHER+ merges with two kernels, left then right
    merges = {"etherplus": ("etherplus_merge_left", "etherplus_merge_right")
              }.get(method, (f"{method}_merge",))
    want = {"unmerged": with_attention((
                {f"{method}_gemm.cuda": per_forward * un["forwards"]},
                {**none, f"{method}_gemm": per_forward * un["forwards"]}),
                cfg, un["forwards"]),
            "merged": with_attention((
                {f"{method}_merge.cuda": per_forward},
                {**none, **dict.fromkeys(merges, per_forward)}), cfg,
                mg["forwards"])}
    check_served(torch, cfg, {"unmerged": un, "merged": mg}, want)
    if method == "etherplus":
        # every shape aligned, d and f multiples of 8: the rule by rows
        from repro_torch.kernels import etherplus_gemm as kep
        check_fwd_routes(un["ep_routes"], served_fwd_routes(
            ops, "etherplus_gemm",
            lambda rows: kep.route(torch.bfloat16, 960, 960, N_BLOCKS, True),
            per_forward, un["forwards"], B * P, B), "etherplus_gemm",
            "unmerged")
    if method == "hyperadapt":
        # every shape aligned, d and f multiples of 8: one route at every
        # row count
        from repro_torch.kernels import hyperadapt_gemm as kh
        check_fwd_routes(un["hg_routes"], served_fwd_routes(
            ops, "hyperadapt_gemm",
            lambda rows: kh.route(torch.bfloat16, 960, 960, True),
            per_forward, un["forwards"], B * P, B), "hyperadapt_gemm",
            "unmerged")
        # its tensor-map cache on the decode path, outside the counted
        # runs: the x⊙r planes (the kept scratch) and W are its TMA sources
        check_map_encodes(decode_map_encodes(
            torch, api, GEN, params, adapters, tokens, cfg, peft,
            kh.map_counts), 2 * per_forward, "hyperadapt_gemm")

    # outside the counted runs: the frozen model, and the plain versions
    base = serve.generate(params, None, tokens, cfg, None, 4)
    plain = serve.generate(params, adapters, tokens, cfg,
                           dataclasses.replace(peft, backend="torch"), 4)
    effect = frob(un["logits"], base["logits"])
    merged_err = frob(mg["logits"], un["logits"])
    plain_err = frob(un["logits"], plain["logits"])
    print(f"adapters vs frozen model: logits rel. Frobenius {effect:.3e} "
          f"(must exceed {SERVE_TOL:g}, so that the checks below can see a "
          f"dropped update)")
    print(f"merged vs unmerged: logits rel. Frobenius {merged_err:.3e} "
          f"(tol {SERVE_TOL:g}), greedy tokens agree "
          f"{agree(mg['tokens'], un['tokens']) * 100:.1f}%")
    print(f"kernels vs plain path: logits rel. Frobenius {plain_err:.3e} "
          f"(tol {SERVE_TOL:g}), greedy tokens agree "
          f"{agree(un['tokens'][:, :5], plain['tokens']) * 100:.1f}%")
    check(effect > SERVE_TOL, f"{method} adapters moved the logits by only "
          f"{effect:.3e}")
    check(merged_err <= SERVE_TOL and plain_err <= SERVE_TOL,
          f"{method} serving paths disagree")

    traces = {}                     # the decode step, outside the counts
    for name, r in (("unmerged", un), ("merged", mg)):
        t = traces[name] = profile_decode(
            torch, serve, api, TRACE_STEPS, merged=r["merge_s"] is not None,
            **kw)
        print_trace(f"{method} {name}", t, r["per_token_s"] * 1e3)
    return dict(adapter_effect=effect, merged_vs_unmerged=merged_err,
                kernels_vs_plain=plain_err,
                token_agreement=agree(mg["tokens"], un["tokens"]),
                **{f"{name}_{k}": r[k] for name, r in
                   (("unmerged", un), ("merged", mg))
                   for k in ("prefill_s", "per_token_s", "peak_gb",
                             "forwards", "merge_s", "counters", "launches",
                             "ep_routes", "hg_routes")},
                traces=traces)


def mamba_f32(torch, serve, api, cfg, peft, tokens):
    """Phase 15's float32 hold: mamba2-1.3b at full width and depth in
    float32 (weights and adapters from phase 15's seeds), one prefill of
    ``tokens`` on the kernels (``ssd_chunk``, ``householder_gemm``)
    against the plain path and against the merged model, each to
    MAMBA_TOL["float32"]: what is left of the bf16 runs' disagreement
    after the rounding is gone."""
    import dataclasses

    from repro_torch.core.peft import init_adapters, merge_params
    c32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params = api.init_model(c32, seed=0, device="cuda")
    adapters = init_adapters(torch.Generator(device="cuda").manual_seed(1),
                             params, peft)
    batch = {"tokens": tokens}
    _, kern = api.prefill(params, adapters, batch, c32, peft)
    _, plain = api.prefill(params, adapters, batch, c32,
                           dataclasses.replace(peft, backend="torch"))
    _, merged = api.prefill(merge_params(params, adapters, peft), None,
                            batch, c32, None)
    out = {"kernels_vs_plain": frob(kern, plain),
           "merged_vs_unmerged": frob(merged, kern)}
    tol = MAMBA_TOL["float32"]
    print(f"float32, P={tokens.shape[1]}: kernels vs plain path logits rel. "
          f"Frobenius {out['kernels_vs_plain']:.3e}, merged vs unmerged "
          f"{out['merged_vs_unmerged']:.3e} (tol {tol:g})", flush=True)
    check(max(out.values()) <= tol, "mamba2 in float32: the kernels' path "
          "disagrees with the plain path or the merged model")
    return out


def mamba_bf16_seed(torch, serve, api, seed):
    """Phase 15's bf16 hold on a second model: mamba2-1.3b ``full()``
    with weights, adapters and prompts from ``seed``, one prefill of
    B = 4 at the longest prompt of MAMBA_PROMPTS on the kernels against
    the plain path and against the merged model, each to
    MAMBA_TOL["bfloat16"], the adapters moving the logits by more."""
    import dataclasses

    from repro_torch.core.peft import merge_params
    m = serve.build(arch=MAMBA_ARCH, variant="full", n_blocks=N_BLOCKS,
                    batch=B, prompt_len=max(MAMBA_PROMPTS), seed=seed,
                    device="cuda")
    cfg, peft, params, adapters = (m[k] for k in ("cfg", "peft", "params",
                                                  "adapters"))
    batch = {"tokens": m["tokens"]}
    _, kern = api.prefill(params, adapters, batch, cfg, peft)
    _, plain = api.prefill(params, adapters, batch, cfg,
                           dataclasses.replace(peft, backend="torch"))
    _, merged = api.prefill(merge_params(params, adapters, peft), None,
                            batch, cfg, None)
    _, frozen = api.prefill(params, None, batch, cfg, None)
    out = {"adapter_effect": frob(kern, frozen),
           "kernels_vs_plain": frob(kern, plain),
           "merged_vs_unmerged": frob(merged, kern)}
    tol = MAMBA_TOL["bfloat16"]
    print(f"seed {seed}, bfloat16, P={batch['tokens'].shape[1]}: adapters "
          f"vs frozen model {out['adapter_effect']:.3e} (must exceed "
          f"{tol:g}), kernels vs plain path {out['kernels_vs_plain']:.3e}, "
          f"merged vs unmerged {out['merged_vs_unmerged']:.3e} (tol "
          f"{tol:g})", flush=True)
    check(out["adapter_effect"] > tol
          and max(out["kernels_vs_plain"], out["merged_vs_unmerged"]) <= tol,
          f"mamba2 serving paths disagree in bf16 on seed {seed}")
    return out


def phase_serve_mamba(torch, execute, ops, serve, api):
    """Phase 15: mamba2-1.3b ``full()`` (48 layers at full width, random
    weights from seed 0) with ETHER n_blocks 8 on in_proj and out_proj,
    served for B = 4 at each prompt length of MAMBA_PROMPTS through
    ``serve.generate``, unmerged and after ``merge_params``, each run
    counted from 0: every prefill layer's chunked scan on ``ssd_chunk``
    (``ssd_chunked.cuda``), every adapted linear on ``householder_gemm``
    (or merged once by ``ether_merge``), no plain version.  Held: merged
    vs unmerged and the kernels' path vs the plain path (backend torch:
    the plain SSD dual form and reflections) to MAMBA_TOL, in bf16 and
    (:func:`mamba_f32`) in float32, the adapters moving the logits by
    more, and again on a model from the second of MAMBA_SEEDS
    (:func:`mamba_bf16_seed`); a right-padded batch with true lengths
    MAMBA_TRUE_LENS against each row's unpadded prompt (its state bitwise,
    its logits to MAMBA_PAD_TOL, its next token).  Prints prefill ms, decode
    ms per token, peak memory and, from traces of a prefill and of the
    decode step, the device's idle share."""
    import dataclasses

    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.core.peft import merge_params
    m = serve.build(arch=MAMBA_ARCH, variant="full", n_blocks=N_BLOCKS,
                    batch=B, prompt_len=max(MAMBA_PROMPTS),
                    seed=MAMBA_SEEDS[0], device="cuda")
    cfg, peft, params, adapters, prompts = (m[k] for k in (
        "cfg", "peft", "params", "adapters", "tokens"))
    weights_bytes = sum(t.numel() * t.element_size()
                        for _, t in flatten_with_paths(params))
    heads = cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim
    print(f"== phase 15: serve {MAMBA_ARCH} full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {heads} heads of "
          f"{cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, {cfg.param_dtype}), ETHER n_blocks={N_BLOCKS} "
          f"on in_proj/out_proj, B={B}, P in {MAMBA_PROMPTS}, gen={GEN}",
          flush=True)
    n = cfg.n_layers
    none = dict.fromkeys(ops.launches(), 0)
    out = {}
    for plen in MAMBA_PROMPTS:
        tokens = prompts[:, :plen].contiguous()

        def merged():
            t0 = time.perf_counter()
            mp = merge_params(params, adapters, peft)
            torch.cuda.synchronize()
            merge_s = time.perf_counter() - t0
            return dict(serve.generate(mp, None, tokens, cfg, None, GEN),
                        merge_s=merge_s)

        print(f"-- prompt length {plen} (chunk "
              f"{min(cfg.ssm_chunk, plen)}, padded to "
              f"{-(-plen // cfg.ssm_chunk) * min(cfg.ssm_chunk, plen)})",
              flush=True)
        un = counted(torch, execute, ops, lambda: dict(serve.generate(
            params, adapters, tokens, cfg, peft, GEN), merge_s=None))
        mg = counted(torch, execute, ops, merged)
        # two prefills a run (warm-up, timed), one scan a layer each; the
        # two adapted linears of every layer in every forward
        scans, hh = 2 * n, 2 * n * un["forwards"]
        want = {"unmerged": ({"householder_gemm.cuda": hh,
                              "ssd_chunked.cuda": scans},
                             {**none, "householder_gemm": hh,
                              "ssd_chunk": scans}),
                "merged": ({"ether_merge.cuda": 2 * n,
                            "ssd_chunked.cuda": scans},
                           {**none, "ether_merge": 2 * n,
                            "ssd_chunk": scans})}
        check_served(torch, cfg, {"unmerged": un, "merged": mg}, want)
        check_routes(un, served_routes(ops, 2 * n, un["forwards"], B * plen,
                                       B), f"unmerged P={plen}")
        check(all(r["counters"].get("ssd_chunked.cuda", 0) > 0
                  and r["launches"]["ssd_chunk"] > 0 for r in (un, mg)),
              "a Mamba-2 serving path launched no SSD kernel")

        # outside the counted runs: the frozen model, and the plain path
        base = serve.generate(params, None, tokens, cfg, None, 4)
        plain = serve.generate(params, adapters, tokens, cfg,
                               dataclasses.replace(peft, backend="torch"), 4)
        effect = frob(un["logits"], base["logits"])
        merged_err = frob(mg["logits"], un["logits"])
        plain_err = frob(un["logits"], plain["logits"])
        tol = MAMBA_TOL["bfloat16"]
        print(f"adapters vs frozen model: logits rel. Frobenius "
              f"{effect:.3e} (must exceed {tol:g})")
        print(f"merged vs unmerged: logits rel. Frobenius {merged_err:.3e} "
              f"(tol {tol:g}), greedy tokens agree "
              f"{agree(mg['tokens'], un['tokens']) * 100:.1f}%")
        print(f"kernels vs plain path: logits rel. Frobenius "
              f"{plain_err:.3e} (tol {tol:g}), greedy tokens agree "
              f"{agree(un['tokens'][:, :5], plain['tokens']) * 100:.1f}%")
        check(effect > tol, f"the adapters moved the logits by only "
              f"{effect:.3e}")
        check(merged_err <= tol and plain_err <= tol,
              f"mamba2 serving paths disagree at P={plen}")

        def one_prefill():
            api.prefill(params, adapters, {"tokens": tokens}, cfg, peft)
            torch.cuda.synchronize()
        traces = {"prefill": trace_steps(torch, one_prefill, 1),
                  "decode": trace_decode(torch, api, TRACE_STEPS, params,
                                         adapters, tokens, cfg, peft)}
        print_trace(f"mamba2 P={plen} prefill", traces["prefill"],
                    un["prefill_s"] * 1e3)
        print_trace(f"mamba2 P={plen} decode", traces["decode"],
                    un["per_token_s"] * 1e3)
        out[plen] = dict(
            adapter_effect=effect, merged_vs_unmerged=merged_err,
            kernels_vs_plain=plain_err,
            token_agreement=agree(mg["tokens"], un["tokens"]),
            **{f"{name}_{k}": r[k] for name, r in
               (("unmerged", un), ("merged", mg))
               for k in ("prefill_s", "per_token_s", "peak_gb", "forwards",
                         "merge_s", "counters", "launches",
                         "routes")},
            traces=traces)

    # the same model in float32, outside the counted runs: the kernels'
    # prefill against the plain path and the merged model
    f32 = mamba_f32(torch, serve, api, cfg, peft, prompts[:, :max(
        MAMBA_PROMPTS)].contiguous())

    # right padding: each row's true length against its unpadded prompt
    lens = torch.tensor(MAMBA_TRUE_LENS)
    cache, logits = api.prefill(params, adapters, {"tokens": prompts}, cfg,
                                peft, true_lens=lens)
    padded = []
    for r, ln in enumerate(MAMBA_TRUE_LENS):
        one, want = api.prefill(params, adapters,
                                {"tokens": prompts[r:r + 1, :ln].contiguous()},
                                cfg, peft)
        err = frob(logits[r:r + 1], want)
        state_err = frob(cache["pos0"]["ssm"][:, r:r + 1], one["pos0"]["ssm"])
        state_equal = torch.equal(cache["pos0"]["ssm"][:, r:r + 1],
                                  one["pos0"]["ssm"])
        got_tok, want_tok = (logits[r, -1].argmax().item(),
                             want[0, -1].argmax().item())
        padded.append(dict(true_len=ln, logits_rel=err, state_rel=state_err,
                           state_equal=state_equal, token=got_tok,
                           unpadded_token=want_tok))
        print(f"true length {ln:3d} of {prompts.shape[1]}: logits rel. "
              f"Frobenius {err:.3e} (tol {MAMBA_PAD_TOL:g}), state "
              f"{state_err:.3e} (bitwise equal: {state_equal}); next token "
              f"{got_tok} vs {want_tok} unpadded", flush=True)
        check(err <= MAMBA_PAD_TOL and state_equal and got_tok == want_tok,
              f"the padded prompt of true length {ln} differs from its "
              f"unpadded prompt")
    del cache, logits, one, want, params, adapters, m
    second = mamba_bf16_seed(torch, serve, api, MAMBA_SEEDS[1])
    return dict(prompts=out, padded=padded, float32=f32, second_seed=second,
                weights_bytes=weights_bytes)


def phase_serve_qwen(torch, execute, ops, serve, api):
    """Phase 17: qwen2.5-32b ``full()`` at full width (d_model 5120, 40
    query heads over 8 KV heads of 128, d_ff 27648, QKV bias, rope θ 1e6,
    an untied 152,064-entry head, bf16), depth cut to QWEN_LAYERS of 64,
    random weights from seed 0, ETHER n_blocks 8 on all seven linears
    (its random hyperplanes are off the identity), B = QWEN_B at P =
    QWEN_P, GEN new tokens, through ``serve.generate`` unmerged and after
    ``merge_params``, each counted from 0: every layer's prefill and
    decode attention on the flash kernel (``flash_attention.cuda``), every
    adapted linear on ``householder_gemm`` (or merged once by
    ``ether_merge``), no plain call.  Held: merged vs unmerged and the
    kernels' path vs the plain path to SERVE_TOL, the adapters moving the
    logits by more, and the logits against ``torch.matmul`` of the final
    hidden state by the untied head (which the tied table would not give).
    Prints prefill ms, decode ms per token, peak memory and, from traces
    of a prefill and of a decode step, the device's idle share."""
    import dataclasses

    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.peft import init_adapters, merge_params
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.models import backbone
    from repro_torch.models.layers import logits_out
    full = get_config(QWEN_ARCH, "full")
    cfg = dataclasses.replace(full, n_layers=min(QWEN_LAYERS, full.n_layers))
    peft = PEFTConfig(method="ether", n_blocks=N_BLOCKS,
                      targets=peft_targets(QWEN_ARCH))
    params = api.init_model(cfg, seed=0, device="cuda")
    adapters = init_adapters(torch.Generator(device="cuda").manual_seed(1),
                             params, peft)
    tokens = torch.randint(0, cfg.vocab, (QWEN_B, QWEN_P),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2), device="cuda")
    weights_bytes = sum(t.numel() * t.element_size()
                        for _, t in flatten_with_paths(params))
    print(f"== phase 17: serve {QWEN_ARCH} full width ({cfg.n_layers} of "
          f"{full.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv} KV heads of {cfg.hd}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, untied head, {cfg.param_dtype}, "
          f"{weights_bytes / 1e9:.2f} GB of weights), ETHER "
          f"n_blocks={N_BLOCKS}, B={QWEN_B} P={QWEN_P} gen={GEN}",
          flush=True)

    def merged():
        t0 = time.perf_counter()
        mp = merge_params(params, adapters, peft)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        return dict(serve.generate(mp, None, tokens, cfg, None, GEN),
                    merge_s=merge_s)

    un = counted(torch, execute, ops, lambda: dict(serve.generate(
        params, adapters, tokens, cfg, peft, GEN), merge_s=None))
    mg = counted(torch, execute, ops, merged)
    per_forward = 7 * cfg.n_layers
    none = dict.fromkeys(ops.launches(), 0)
    want = {"unmerged": with_attention((
                {"householder_gemm.cuda": per_forward * un["forwards"]},
                {**none, "householder_gemm": per_forward * un["forwards"]}),
                cfg, un["forwards"]),
            "merged": with_attention((
                {"ether_merge.cuda": per_forward},
                {**none, "ether_merge": per_forward}), cfg, mg["forwards"])}
    check_served(torch, cfg, {"unmerged": un, "merged": mg}, want,
                 batch=QWEN_B, prompt_len=QWEN_P)
    check_routes(un, served_routes(ops, per_forward, un["forwards"],
                                   QWEN_B * QWEN_P, QWEN_B), "unmerged")

    # outside the counted runs: the plain path, the frozen model, and the
    # untied head against torch.matmul of the final hidden state
    batch = {"tokens": tokens}
    _, plain = api.prefill(params, adapters, batch, cfg,
                           dataclasses.replace(peft, backend="torch"))
    _, frozen = api.prefill(params, None, batch, cfg, None)
    effect = frob(un["logits"], frozen)
    merged_err = frob(mg["logits"], un["logits"])
    plain_err = frob(un["logits"], plain)
    del plain, frozen
    with torch.no_grad():
        hidden, _ = backbone.forward(params, cfg, tokens=tokens,
                                     adapters=adapters, peft=peft,
                                     mode="prefill")
        last = hidden[:, -1:]
        by_matmul = torch.matmul(last.float(),
                                 params["lm_head"]["kernel"].float())
        head_err = frob(un["logits"], by_matmul)
        tied_apart = frob(logits_out(params["embed"], last), by_matmul)
    del hidden
    print(f"adapters vs frozen model: logits rel. Frobenius {effect:.3e} "
          f"(must exceed {SERVE_TOL:g})")
    print(f"merged vs unmerged: logits rel. Frobenius {merged_err:.3e} "
          f"(tol {SERVE_TOL:g}), greedy tokens agree "
          f"{agree(mg['tokens'], un['tokens']) * 100:.1f}%")
    print(f"kernels vs plain path: logits rel. Frobenius {plain_err:.3e} "
          f"(tol {SERVE_TOL:g})")
    print(f"untied head: logits vs torch.matmul(hidden, lm_head) rel. "
          f"Frobenius {head_err:.3e} (tol {QWEN_HEAD_TOL:g}); the tied "
          f"table's logits lie {tied_apart:.3e} apart", flush=True)
    check(effect > SERVE_TOL, f"qwen2.5-32b adapters moved the logits by "
          f"only {effect:.3e}")
    check(merged_err <= SERVE_TOL and plain_err <= SERVE_TOL,
          "qwen2.5-32b serving paths disagree")
    check(head_err <= QWEN_HEAD_TOL and tied_apart > 0.5,
          f"qwen2.5-32b logits are not the untied head's ({head_err:.3e}, "
          f"tied {tied_apart:.3e})")

    def one_prefill():
        api.prefill(params, adapters, batch, cfg, peft)
        torch.cuda.synchronize()
    traces = {"prefill": trace_steps(torch, one_prefill, 1),
              "decode": trace_decode(torch, api, 1, params, adapters, tokens,
                                     cfg, peft)}
    print_trace("qwen2.5-32b prefill", traces["prefill"],
                un["prefill_s"] * 1e3)
    print_trace("qwen2.5-32b decode", traces["decode"],
                un["per_token_s"] * 1e3)
    return dict(adapter_effect=effect, merged_vs_unmerged=merged_err,
                kernels_vs_plain=plain_err, head_vs_matmul=head_err,
                tied_apart=tied_apart, weights_bytes=weights_bytes,
                n_layers=cfg.n_layers,
                token_agreement=agree(mg["tokens"], un["tokens"]),
                **{f"{name}_{k}": r[k] for name, r in
                   (("unmerged", un), ("merged", mg))
                   for k in ("prefill_s", "per_token_s", "peak_gb",
                             "forwards", "merge_s", "counters", "launches",
                             "routes", "flash_routes")},
                traces=traces)


BANK_OP = {"ether": "householder_gemm_batched",
           "etherplus": "etherplus_reflect_batched",
           "delora": "delora_gemm_batched",
           "hyperadapt": "hyperadapt_gemm_batched"}
# each tenant of phase 12 moved off its method's identity, as phases 5, 7
# and 9 move their one tenant (ETHER's random u is no identity)
BANK_MOVES = {"ether": {},
              "etherplus": {k: lambda t, z: t + EP_SPREAD * z
                            for k in ("v1", "v2")},
              "delora": {"b": lambda t, z: z,
                         "lam": lambda t, z: DELORA_LAM
                         + DELORA_LAM_SPREAD * z},
              "hyperadapt": {"r": lambda t, z: 1 + HA_SPREAD * z,
                             "c": lambda t, z: 1 + HA_SPREAD * z}}


def phase_serve_bank(torch, execute, ops, serve, api, method):
    """Phase 12: phase 3's model and requests served from a bank of
    BANK_TENANTS tenants (each from its own seed, moved off its method's
    identity) through ``serve.generate``'s bank path, ids BANK_IDS (after
    ``validate_tenant_ids``), then tenant 0 merged (the ``--tenants``
    mode's baseline), each with every count set to 0 just before it.
    Holds the bank against the plain path on the card and each row
    against single-tenant unmerged serving of its tenant on the kernels
    (a prefill per distinct tenant), requires every row to move by more
    than SERVE_TOL when served by another tenant, and traces the bank's
    decode step."""
    import dataclasses

    from repro_torch.core import methods
    from repro_torch.core.peft import (AdapterBank,
                                       _flatten_adapter_modules,
                                       init_adapters, merge_params,
                                       validate_tenant_ids)
    op = BANK_OP[method]
    print(f"== phase 12: serve {ARCH} full width from a bank of "
          f"{BANK_TENANTS} {method} tenants (n_blocks={N_BLOCKS}, rank "
          f"{METHOD_RANK}), B={B} P={P} gen={GEN}, ids {BANK_IDS}",
          flush=True)
    kw = dict(arch=ARCH, variant="full", method=method, n_blocks=N_BLOCKS,
              rank=METHOD_RANK, batch=B, prompt_len=P, seed=0, device="cuda")
    m = serve.build(**kw)
    cfg, peft, params, tokens = (m[k] for k in ("cfg", "peft", "params",
                                                "tokens"))
    del m
    t0 = time.perf_counter()
    trees = [off_init(torch, init_adapters(
        torch.Generator(device="cuda").manual_seed(100 + t), params, peft),
        BANK_MOVES[method], 1000 + t) for t in range(BANK_TENANTS)]
    bank = AdapterBank.stack(trees, params, peft)
    del trees
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.as_tensor(validate_tenant_ids(BANK_IDS, BANK_TENANTS),
                          device="cuda")

    def merged():
        t0 = time.perf_counter()
        mp = merge_params(params, bank.select(0), peft)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        return dict(serve.generate(mp, None, tokens, cfg, None, GEN),
                    merge_s=merge_s)

    bk = counted(torch, execute, ops, lambda: dict(serve.generate(
        params, bank, tokens, cfg, peft, GEN, tenant_ids=ids), merge_s=None))
    mg = counted(torch, execute, ops, merged)
    per_forward = 7 * cfg.n_layers * (2 if method == "etherplus" else 1)
    none = dict.fromkeys(ops.launches(), 0)
    merges = {"etherplus": ("etherplus_merge_left", "etherplus_merge_right")
              }.get(method, (f"{method}_merge",))
    want = {"bank": with_attention((
                {f"{op}.cuda": per_forward * bk["forwards"]},
                {**none, op: per_forward * bk["forwards"]}), cfg,
                bk["forwards"]),
            "merged t=0": with_attention((
                {f"{method}_merge.cuda": 7 * cfg.n_layers},
                {**none, **dict.fromkeys(merges, 7 * cfg.n_layers)}), cfg,
                mg["forwards"])}
    check_served(torch, cfg, {"bank": bk, "merged t=0": mg}, want)
    if method == "ether":
        from repro_torch.kernels import batched as kb
        check_fwd_routes(bk["bank_routes"], served_fwd_routes(
            ops, "householder_gemm_batched",
            lambda s: kb.gemm_route(torch.bfloat16, 960, 960, N_BLOCKS,
                                    True),
            per_forward, bk["forwards"], P, 1), "householder_gemm_batched",
            "bank")
    if method == "delora":
        from repro_torch.kernels import batched as kb
        check_fwd_routes(bk["dl_routes"], served_fwd_routes(
            ops, "delora_gemm_batched",
            lambda s: kb.delora_route(torch.bfloat16, 960, 960, METHOD_RANK,
                                      True),
            per_forward, bk["forwards"], P, 1), "delora_gemm_batched",
            "bank")
        # its tensor-map cache on the bank's decode path, outside the
        # counted runs: x (the caller's activations) and W are its TMA
        # sources
        check_map_encodes(decode_map_encodes(
            torch, api, GEN, params, bank, tokens, cfg, peft,
            kb.delora_map_counts, tenant_ids=ids), 2 * per_forward,
            "delora_gemm_batched")
    if method == "hyperadapt":
        from repro_torch.kernels import batched as kb
        check_fwd_routes(bk["ha_routes"], served_fwd_routes(
            ops, "hyperadapt_gemm_batched",
            lambda s: kb.hyperadapt_route(torch.bfloat16, 960, 960, True),
            per_forward, bk["forwards"], P, 1), "hyperadapt_gemm_batched",
            "bank")
        # its tensor-map cache on the bank's decode path, outside the
        # counted runs: xr, the kept scratch, is a TMA source
        check_map_encodes(decode_map_encodes(
            torch, api, GEN, params, bank, tokens, cfg, peft,
            kb.hyperadapt_map_counts, tenant_ids=ids), 2 * per_forward,
            "hyperadapt_gemm_batched")

    # outside the counted runs: the plain path on the card, each distinct
    # tenant served alone on the single-tenant kernels, and every row
    # served by another tenant
    plain = serve.generate(params, bank, tokens, cfg,
                           dataclasses.replace(peft, backend="torch"), 4,
                           tenant_ids=ids)
    plain_err = frob(bk["logits"], plain["logits"])
    rows_err = {}
    for t in sorted(set(BANK_IDS)):
        sel = [i for i, x in enumerate(BANK_IDS) if x == t]
        _, alone = api.prefill(params, bank.select(t),
                               {"tokens": tokens[sel]}, cfg, peft)
        rows_err[t] = frob(bk["logits"][sel], alone)
    other = ids.roll(1)               # every row another tenant than before
    _, moved = api.prefill(params, bank, {"tokens": tokens}, cfg, peft,
                           tenant_ids=other)
    apart = min(frob(moved[i], bk["logits"][i]) for i in range(B))
    print(f"bank vs plain path: logits rel. Frobenius {plain_err:.3e} (tol "
          f"{SERVE_TOL:g}), greedy tokens agree "
          f"{agree(bk['tokens'][:, :5], plain['tokens']) * 100:.1f}%")
    print("bank rows vs single-tenant serving of their tenant (unmerged, "
          "the single-tenant kernels): " + ", ".join(
              f"tenant {t} {e:.3e}" for t, e in rows_err.items())
          + f" (tol {SERVE_TOL:g})")
    print(f"every row served by another tenant ({other.tolist()}): logits "
          f"move by at least {apart:.3e} (must exceed {SERVE_TOL:g})")
    check(plain_err <= SERVE_TOL, f"{method} bank vs plain path "
          f"{plain_err:.3e}")
    check(max(rows_err.values()) <= SERVE_TOL, f"{method} bank rows vs "
          f"single-tenant serving {rows_err}")
    check(apart > SERVE_TOL, f"{method} tenants' logits differ by only "
          f"{apart:.3e}")

    scale = {}
    if method == "delora":
        # the bank forward's scale of every tenant (as in the JAX package),
        # against the scale of the gathered ids only, over one layer's
        # seven linears (layer 0's bank)
        lay = [a for _, a in _flatten_adapter_modules(bank.tree)]
        sc = methods.get("delora").scale
        one = [(a["a"][0], a["b"][0], a["lam"][0]) for a in lay]
        scale = {
            "all_tenants_ms_per_layer": timed_ms(torch, [
                lambda: [sc(*x) for x in one]]),
            "gathered_ms_per_layer": timed_ms(torch, [
                lambda: [sc(x[0][ids], x[1][ids], x[2][ids]) for x in one]]),
            "bank_bytes_read_per_layer": sum(
                (x[0].numel() + x[1].numel()) * 4 for x in one)}
        print(f"DeLoRA's scale of all {BANK_TENANTS} tenants: "
              f"{scale['all_tenants_ms_per_layer']:.4f} ms a layer "
              f"({scale['bank_bytes_read_per_layer'] / 1e6:.1f} MB of a, b "
              f"read), of the gathered ids only "
              f"{scale['gathered_ms_per_layer']:.4f} ms")
    overhead = bk["per_token_s"] / mg["per_token_s"] - 1
    print(f"bank: {bank.size_bytes() / 1e6:.2f} MB for {BANK_TENANTS} "
          f"tenants ({bank.size_bytes() / BANK_TENANTS / 1e3:.1f} KB a "
          f"tenant, built in {build_s:.1f} s); decode overhead of the "
          f"unmerged bank over merged tenant 0: {overhead * 100:+.1f}% a "
          f"token")
    trace = trace_decode(torch, api, TRACE_STEPS, params, bank, tokens, cfg,
                         peft, tenant_ids=ids)
    print_trace(f"{method} bank", trace, bk["per_token_s"] * 1e3)
    return dict(bank_vs_plain=plain_err, rows_vs_single_tenant=rows_err,
                other_tenant_min=apart, bank_bytes=bank.size_bytes(),
                overhead=overhead, build_s=build_s, scale=scale,
                **{f"{name}_{k}": r[k] for name, r in
                   (("bank", bk), ("merged", mg))
                   for k in ("prefill_s", "per_token_s", "peak_gb",
                             "forwards", "merge_s", "counters", "launches",
                             "bank_routes", "ha_routes", "dl_routes")},
                trace=trace)


def phase_baselines(torch, execute, ops, serve):
    """Phase 11: LoRA, OFT, Naive and full finetuning, plain PyTorch, at
    full width on the card: a short serve (LoRA, OFT, Naive unmerged and
    merged, adapters moved off their init; ``full`` unmerged), then
    BASELINE_STEPS train steps from each method's init through
    ``launch/steps``; nothing may dispatch to a kernel but serving's
    attention (every layer of every forward on the flash kernel); the
    training's attention dispatches its plain route under autograd."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.peft import merge_params
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.launch import steps
    from repro_torch.optim import adamw, cosine
    print(f"== phase 11: LoRA (rank {METHOD_RANK}), OFT, Naive (n_blocks "
          f"{N_BLOCKS} serving, {TRAIN_BLOCKS} training) and full "
          f"finetuning, {ARCH} full width, plain PyTorch: serve B={B} P={P} "
          f"gen={BASELINE_GEN}, train {BASELINE_STEPS} steps B={TRAIN_B} "
          f"S={TRAIN_S}", flush=True)
    cfg = get_config(ARCH, "full")
    none = ({}, dict.fromkeys(ops.launches(), 0))
    out = {}
    for method in ("lora", "oft", "naive", "full"):
        kw = dict(arch=ARCH, variant="full", method=method,
                  n_blocks=N_BLOCKS, rank=METHOD_RANK, batch=B, prompt_len=P,
                  seed=0, device="cuda")
        m = serve.build(**kw)
        peft, params, tokens = m["peft"], m["params"], m["tokens"]
        spread = BASELINE_SPREAD.get(method, 0.0)
        adapters = off_init(torch, m["adapters"], {
            "lora": {"b": lambda t, z: spread * z},
            "oft": {"r": lambda t, z: spread * z},
            "naive": {"m": lambda t, z: t + spread * z}}.get(method, {}), 11)
        runs = {"unmerged": counted(torch, execute, ops, lambda: dict(
            serve.generate(params, adapters, tokens, cfg, peft,
                           BASELINE_GEN), merge_s=None))}
        if method != "full":
            runs["merged"] = counted(torch, execute, ops, lambda: dict(
                serve.generate(merge_params(params, adapters, peft), None,
                               tokens, cfg, None, BASELINE_GEN),
                merge_s=None))
        res = {"merged_vs_unmerged": None}
        for name, r in runs.items():
            want = with_attention(none, cfg, r["forwards"])
            check((r["counters"], r["launches"]) == want,
                  f"{method} {name} ran {r['counters']} / launched "
                  f"{r['launches']}; it has no kernel but the attention's, "
                  f"want {want}")
            check_flash_routes(torch, cfg, r, P, True, f"{method} {name}")
            check(bool(torch.isfinite(r["logits"]).all()),
                  f"{method} {name} logits are not finite")
            res[f"{name}_per_token_s"] = r["per_token_s"]
            res[f"{name}_peak_gb"] = r["peak_gb"]
        if "merged" in runs:
            res["merged_vs_unmerged"] = frob(runs["merged"]["logits"],
                                             runs["unmerged"]["logits"])
            check(res["merged_vs_unmerged"] <= SERVE_TOL,
                  f"{method} merged vs unmerged logits "
                  f"{res['merged_vs_unmerged']:.3e} > {SERVE_TOL:g}")
        del m, params, adapters, runs

        peft = PEFTConfig(method=method, n_blocks=TRAIN_BLOCKS,
                          rank=METHOD_RANK, alpha=float(METHOD_RANK),
                          targets=peft_targets(ARCH))
        opt = adamw(cosine(TRAIN_LR, TRAIN_STEPS, TRAIN_WARMUP))
        state = steps.init_state(cfg, peft, opt, seed=0, device="cuda")
        step = steps.make_train_step(cfg, peft, opt)
        stream = SyntheticLMStream(vocab=cfg.vocab, batch=TRAIN_B,
                                   seq_len=TRAIN_S, seed=0)
        execute.reset_counters()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for i in range(BASELINE_STEPS):
            batch = {k: torch.from_numpy(v).long().cuda()
                     for k, v in stream.batch_at(i).items()}
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())       # synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
        want = (train_attention(cfg, BASELINE_STEPS), none[1])
        check((execute.counters(), ops.launches()) == want,
              f"{method} training ran {execute.counters()} / launched "
              f"{ops.launches()}; it has no kernel, want {want}")
        check(all(map(math.isfinite, losses)),
              f"{method} train losses {losses} are not finite")
        res.update(losses=losses, step_ms=step_ms,
                   train_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   trainable=sum(t.numel() for _, t in flatten_with_paths(
                       state["params" if method == "full" else "adapters"])))
        del state
        out[method] = res
        print(f"[{method}] serve decode {res['unmerged_per_token_s'] * 1e3:.2f}"
              f" ms/token unmerged"
              + (f", merged vs unmerged logits rel. Frobenius "
                 f"{res['merged_vs_unmerged']:.3e} (tol {SERVE_TOL:g})"
                 if res["merged_vs_unmerged"] is not None else "")
              + f"; train {res['trainable']:,} parameters, losses "
              f"{[round(x, 4) for x in losses]}, step ms "
              f"{[round(x, 1) for x in step_ms]}, peak memory "
              f"{res['train_peak_gb']:.3f} GB", flush=True)
    return out


def moved_off_init(torch, method):
    """Phase 13's start for ETHER+ (v1, v2 drawn EP_SPREAD·N(0, 1) apart
    from u1, u2: the init's v = u is H⁺ = I, under which blockgemm and
    weight mode agree trivially), DeLoRA (b = DELORA_B0·N(0, 1), where its
    update is no sign pattern) and HyperAdapt (r, c = 1 + HA_SPREAD·N(0,
    1)): a function that moves a new Trainer's adapters there in place,
    from one seed, so every run of a method starts equal.  None for ETHER
    (its init is a random hyperplane)."""
    from repro_torch.common.pytree import flatten_with_paths
    # leaf → (base, spread): the leaf becomes base + spread·N(0, 1), or,
    # with base None, moves by spread·N(0, 1) from where it is
    spread = {"etherplus": {"v1": (None, EP_SPREAD), "v2": (None, EP_SPREAD)},
              "delora": {"b": (0.0, DELORA_B0)},
              "hyperadapt": {"r": (1.0, HA_SPREAD),
                             "c": (1.0, HA_SPREAD)}}.get(method)
    if spread is None:
        return None

    def start(tr):
        gen = torch.Generator(device="cuda").manual_seed(8)
        with torch.no_grad():
            for p, leaf in flatten_with_paths(tr.state["adapters"]):
                name = p.rsplit("/", 1)[-1]
                if name in spread:
                    base, sd = spread[name]
                    leaf.copy_((leaf if base is None else base) + sd
                               * torch.randn(leaf.shape, generator=gen,
                                             device="cuda"))
    return start


def train_attention(cfg, steps):
    """The dispatch counters of a train run's attention: every layer's
    forward and its remat recompute on the plain route under autograd
    (the flash kernel has no backward, nor has the Pallas kernel)."""
    per_step = (2 if cfg.remat == "full" else 1) * cfg.n_layers
    return {"flash_attention.torch": per_step * steps}


def expected_train_counts(method, mode, cfg, steps, launch_keys):
    """Per train run of ``steps`` steps, the dispatch counters and kernel
    launches of ``method`` in ``mode``: each of the 7·L adapted linears'
    forward and its remat recompute, and one backward (no dW: PEFT
    freezes W); the attention's (:func:`train_attention`)."""
    n = 7 * cfg.n_layers * steps
    if mode == "weight":
        # the merge forward twice (remat), its backward once; ETHER+'s
        # two-sided backward recomputes H⁺W (etherplus_merge_left)
        op = f"{method}_merge"
        counters = {f"{op}.cuda": 2 * n, f"{op}_bwd.cuda": n}
        launches = {"ether": {"ether_merge": 2 * n, "merge_left_bwd": n},
                    "etherplus": {"etherplus_merge_left": 3 * n,
                                  "etherplus_merge_right": 2 * n,
                                  "merge_right_bwd": n, "merge_left_bwd": n},
                    "delora": {"delora_merge": 2 * n},
                    "hyperadapt": {"hyperadapt_merge": 2 * n}}[method]
    elif mode == "blockgemm":         # plain PyTorch, as in the JAX package
        counters, launches = {}, {}
    else:
        # the reflections' backward runs reflect_gemm_dx, which under
        # two-sided ETHER+ comes after a y0 recompute by the one-sided
        # forward kernel and etherplus_reflect_bwd; DeLoRA's dx is its
        # forward kernel on Wᵀ; HyperAdapt's z and y0 are its forward
        # kernel without the column scale
        fwd = f"{method}_gemm" if method in ("delora", "hyperadapt") else {
            "ether": "householder_gemm", "etherplus": "etherplus_gemm"}[
            method]
        counters = {f"{fwd}.cuda": 2 * n, f"{fwd}_bwd.cuda": n}
        launches = {"ether": {"householder_gemm": 2 * n,
                              "reflect_gemm_dx": n},
                    "etherplus": {"etherplus_gemm": 3 * n,
                                  "etherplus_reflect_bwd": n,
                                  "reflect_gemm_dx": n},
                    "delora": {"delora_gemm": 3 * n},
                    "hyperadapt": {"hyperadapt_gemm": 4 * n}}[method]
    return ({**counters, **train_attention(cfg, steps)},
            {**dict.fromkeys(launch_keys, 0), **launches})


def phase_train(torch, execute, ops, phase, method, mode="activation",
                steps=None, ckpt=None, start=None):
    """Phases 4 (``method`` "ether"), 6 ("etherplus", two-sided), 8
    ("delora") and 10 ("hyperadapt"): PEFT training of smollm-360m at full
    width through the port's Trainer, from the method's own init; see the
    module docstring.  Phase 13 runs it in weight mode (``mode``), for
    ``steps`` steps with a checkpoint at ``ckpt``, each Trainer's adapters
    first moved by ``start`` (:func:`moved_off_init`); TRAIN_STEPS and
    TRAIN_CKPT by default."""
    import shutil
    import tempfile

    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.optim import adamw, cosine
    from repro_torch.runtime.trainer import Trainer

    cfg = get_config(ARCH, "full")
    steps = TRAIN_STEPS if steps is None else steps
    ckpt = TRAIN_CKPT if ckpt is None else ckpt
    tokens = TRAIN_B * TRAIN_S
    label = {"ether": f"ETHER n_blocks={TRAIN_BLOCKS}",
             "etherplus": f"ETHER+ two-sided n_blocks={TRAIN_BLOCKS}",
             "delora": f"DeLoRA rank {METHOD_RANK}",
             "hyperadapt": "HyperAdapt"}[method]
    if start is not None:
        label += {"etherplus": f", v from u + {EP_SPREAD:g}·N(0, 1)",
                  "delora": f", from b = {DELORA_B0:g}·N(0, 1)",
                  "hyperadapt": f", from r, c = 1 + {HA_SPREAD:g}·N(0, 1)"
                  }[method]
    print(f"== phase {phase}: train {ARCH} full width ({cfg.n_layers} layers, "
          f"{cfg.param_dtype}, remat {cfg.remat!r}), {label}, mode {mode}, "
          f"B={TRAIN_B} S={TRAIN_S}, AdamW lr "
          f"{TRAIN_LR:g} cosine warmup {TRAIN_WARMUP}, {steps} steps",
          flush=True)
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=TRAIN_B,
                               seq_len=TRAIN_S, seed=0)

    def trainer(backend, name, **kw):
        peft = PEFTConfig(method=method, n_blocks=TRAIN_BLOCKS,
                          rank=METHOD_RANK, alpha=float(METHOD_RANK),
                          targets=peft_targets(ARCH), mode=mode,
                          backend=backend)
        opt = adamw(cosine(TRAIN_LR, steps, TRAIN_WARMUP))
        t = Trainer(cfg, peft, opt, seed=0, device="cuda",
                    log_path=os.path.join(tmp, f"{name}.jsonl"), **kw)
        if start is not None and t.step == 0:
            start(t)
        return t

    def logged(name):
        """The metrics of every step a Trainer ran, from its JSONL log."""
        with open(os.path.join(tmp, f"{name}.jsonl")) as fh:
            return [json.loads(line) for line in fh]

    def snapshot(tree):
        return {p: t.detach().clone() for p, t in flatten_with_paths(tree)}

    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # the main path, counted: every count set to 0 just before fit
        tr = trainer("auto", "a", ckpt_dir=os.path.join(tmp, "a"),
                     ckpt_every=ckpt)
        init = snapshot(tr.state["adapters"])
        execute.reset_counters()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.fit(stream, steps=steps)
        fit_s = time.perf_counter() - t0
        counters, launches = execute.counters(), ops.launches()
        routes = ops.routes()
        dx_routes = ops.routes("reflect_gemm_dx")
        ep_routes = ops.routes("etherplus_gemm")
        hg_routes = ops.routes("hyperadapt_gemm")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        final = {k: snapshot(tr.state[k])
                 for k in ("adapters", "opt_state", "step")}
        tr.close()
        log = logged("a")

        want = expected_train_counts(method, mode, cfg, steps,
                                     ops.launches())
        print(f"[kernels] dispatch counters: {counters}  kernel launches: "
              f"{launches}")
        check((counters, launches) == want,
              f"train path ran {counters} / launched {launches}, want "
              f"{want[0]} / {want[1]} (forward + remat recompute + backward "
              f"of {7 * cfg.n_layers} linears a step, no plain version; "
              f"attention on the plain route under autograd)")
        if launches["householder_gemm"]:
            # B·S rows, bf16: every forward on the wgmma route
            check_routes(dict(routes=routes), {
                **dict.fromkeys(routes, 0),
                "householder_gemm.wgmma": launches["householder_gemm"]},
                "kernels")
        check_dx_routes(dx_routes, launches, "reflect_gemm_dx", "kernels")
        if launches["etherplus_gemm"]:
            # B·S rows, bf16: the forward, its remat recompute and the
            # backward's y0 recompute all on the wgmma route
            check_dx_routes(ep_routes, launches, "etherplus_gemm", "kernels")
        if launches["hyperadapt_gemm"]:
            # B·S rows, bf16: the forward, its remat recompute and the
            # backward's z and y0 all on the wgmma route
            check_dx_routes(hg_routes, launches, "hyperadapt_gemm",
                            "kernels")
        losses = [m["loss"] for m in log]
        check(len(losses) == steps
              and all(map(math.isfinite, losses + [m["grad_norm"]
                                                    for m in log])),
              f"train losses {losses} are not {steps} finite values")
        step_ms = [m["step_time"] * 1e3 for m in log]
        steady_ms = sum(step_ms[1:]) / max(len(step_ms) - 1, 1)
        print(f"[kernels] losses {[round(x, 4) for x in losses]}")
        print(f"[kernels] step ms {[round(x, 1) for x in step_ms]} (first "
              f"includes warm-up); steady {steady_ms:.1f} ms = "
              f"{tokens / steady_ms * 1e3:.0f} tokens/s; fit {fit_s:.2f} s "
              f"with checkpoints; peak memory {peak_gb:.3f} GB")

        # the plain path on the card, outside the counted run
        ref_tr = trainer("torch", "plain")
        ref_tr.fit(stream, steps=steps)
        ref_final = snapshot(ref_tr.state["adapters"])
        ref_tr.close()
        ref_log = logged("plain")
        ref_losses = [m["loss"] for m in ref_log]

        def agreement(log, ref_log, init, final, ref_final):
            """Per step, the largest relative difference of the loss and of
            the gradient norm; and the relative Frobenius norm of the
            difference of the adapters' total updates."""
            def rel(key):
                return max(abs(a[key] - b[key]) / abs(b[key])
                           for a, b in zip(log, ref_log))
            num = sum(((final[p] - init[p]) - (ref_final[p] - init[p]))
                      .float().square().sum().item() for p in init)
            den = sum((ref_final[p] - init[p]).float().square().sum().item()
                      for p in init)
            return rel("loss"), rel("grad_norm"), math.sqrt(num / den)

        def report(what, loss_rel, gnorm_rel, upd_rel, upd_checked=True):
            print(f"{what}: loss rel. diff max {loss_rel:.3e} (tol "
                  f"{TRAIN_TOL['loss']:g}), grad_norm rel. diff max "
                  f"{gnorm_rel:.3e} (tol {TRAIN_TOL['grad_norm']:g}), "
                  f"adapter update rel. Frobenius {upd_rel:.3e} "
                  + (f"(tol {TRAIN_TOL['update']:g})" if upd_checked else
                     "(not held to a limit here: see below)"))

        loss_rel, gnorm_rel, upd_rel = agreement(
            log, ref_log, init, final["adapters"], ref_final)
        ref_ms = [m["step_time"] * 1e3 for m in ref_log]
        print(f"[plain] losses {[round(x, 4) for x in ref_losses]}; steady "
              f"{sum(ref_ms[1:]) / max(len(ref_ms) - 1, 1):.1f} ms/step")
        # DeLoRA's b starts at 0, so its first update is Adam's sign of
        # db (at s = λ/(r·ε)) and b's direction is nothing but that sign
        # pattern: the elements of db at rounding level take either sign
        # on either path, and the two updates part by 0.107 (PERF.md, run
        # P) where the losses and gradient norms agree.  The update is
        # held to its limit on a pair of runs from b ≠ 0 instead, below
        sign_led = method == "delora" and start is None
        report("kernels vs plain path", loss_rel, gnorm_rel, upd_rel,
               not sign_led)
        check(len(ref_log) == steps and loss_rel <= TRAIN_TOL["loss"]
              and gnorm_rel <= TRAIN_TOL["grad_norm"]
              and (sign_led or upd_rel <= TRAIN_TOL["update"]),
              "the kernels' training path disagrees with the plain path")
        b0 = None
        if sign_led:
            runs = {}
            for backend in ("auto", "torch"):
                t = trainer(backend, f"b0_{backend}")
                gen = torch.Generator(device="cuda").manual_seed(8)
                with torch.no_grad():
                    for p, leaf in flatten_with_paths(t.state["adapters"]):
                        if p.endswith("/b"):
                            leaf.copy_(DELORA_B0 * torch.randn(
                                leaf.shape, generator=gen, device="cuda"))
                first = snapshot(t.state["adapters"])
                t.fit(stream, steps=steps)
                runs[backend] = (logged(f"b0_{backend}"), first,
                                 snapshot(t.state["adapters"]))
                t.close()
            check(all(torch.equal(runs["auto"][1][p], runs["torch"][1][p])
                      for p in runs["auto"][1]), "the b ≠ 0 pair differs at "
                  "its start")
            b0 = agreement(runs["auto"][0], runs["torch"][0],
                           runs["auto"][1], runs["auto"][2],
                           runs["torch"][2])
            report(f"from b = {DELORA_B0:g}·N(0, 1), kernels vs plain path",
                   *b0)
            check(b0[0] <= TRAIN_TOL["loss"]
                  and b0[1] <= TRAIN_TOL["grad_norm"]
                  and b0[2] <= TRAIN_TOL["update"],
                  "from b ≠ 0, the kernels' DeLoRA training path disagrees "
                  "with the plain path")

        # restore from the step-ckpt checkpoint in a new Trainer
        shutil.copytree(os.path.join(tmp, "a", f"step_{ckpt}"),
                        os.path.join(tmp, "b", f"step_{ckpt}"))
        res_tr = trainer("auto", "b", ckpt_dir=os.path.join(tmp, "b"),
                         ckpt_every=ckpt)
        check(res_tr.step == ckpt and res_tr.data_state.step == ckpt,
              f"restored at step {res_tr.step}, want {ckpt}")
        res_tr.fit(stream, steps=steps)
        mism = [f"{k}/{p}" for k in final
                for p, t in flatten_with_paths(res_tr.state[k])
                if not torch.equal(t, final[k][p])]
        check(not mism and [m["loss"] for m in logged("b")]
              == losses[ckpt:],
              f"resumed run differs from the uninterrupted one: {mism[:5]}")
        print(f"restore from step {ckpt} -> {steps}: adapters, "
              f"optimizer state and step bitwise equal "
              f"({sum(len(v) for v in final.values())} tensors), losses "
              f"equal")

        # the train step under torch.profiler, outside the counted runs
        def two_steps():
            res_tr.fit(stream, steps=res_tr.step + 2)
            torch.cuda.synchronize()
        res_tr.ckpt.close()
        res_tr.ckpt = None              # no saves inside the trace
        trace = trace_steps(torch, two_steps, 2)
        res_tr.close()
        print_trace("train", trace, steady_ms)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(mode=mode, steps=steps, losses=losses,
                plain_losses=ref_losses, step_ms=step_ms,
                steady_ms=steady_ms, plain_step_ms=ref_ms,
                tokens_per_s=tokens / steady_ms * 1e3, peak_gb=peak_gb,
                fit_s=fit_s, loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
                update_rel=upd_rel, from_b_nonzero=b0,
                grad_norms=[m["grad_norm"] for m in log],
                plain_grad_norms=[m["grad_norm"] for m in ref_log],
                counters=counters, launches=launches, routes=routes,
                dx_routes=dx_routes, ep_routes=ep_routes,
                hg_routes=hg_routes, trace=trace)


def phase_blockgemm(torch, execute, ops, method, weight):
    """Phase 13, blockgemm: ``method`` trained BLOCKGEMM_STEPS steps in
    blockgemm mode (the paper's dense (db × db) blocks and n block GEMMs,
    plain PyTorch as in the JAX package) from the same start
    (:func:`moved_off_init`) and schedule as the weight-mode run
    ``weight``, counted: no kernel op dispatches (the attention takes
    its plain route under autograd).  Its per-step losses
    are held to weight mode's within BLOCKGEMM_TOL; the schedule's first
    step has lr 0 (warmup), so the last loss is the first to follow an
    update."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.optim import adamw, cosine
    from repro_torch.runtime.trainer import Trainer

    cfg = get_config(ARCH, "full")
    print(f"== phase 13: train {ARCH} full width, {method} blockgemm mode, "
          f"{BLOCKGEMM_STEPS} steps against weight mode's", flush=True)
    peft = PEFTConfig(method=method, n_blocks=TRAIN_BLOCKS,
                      targets=peft_targets(ARCH), mode="blockgemm")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_blockgemm_")
    try:
        log_path = os.path.join(tmp, "log.jsonl")
        tr = Trainer(cfg, peft, adamw(cosine(TRAIN_LR, weight["steps"],
                                             TRAIN_WARMUP)),
                     seed=0, device="cuda", log_path=log_path)
        start = moved_off_init(torch, method)
        if start is not None:
            start(tr)
        execute.reset_counters()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        tr.fit(SyntheticLMStream(vocab=cfg.vocab, batch=TRAIN_B,
                                 seq_len=TRAIN_S, seed=0),
               steps=BLOCKGEMM_STEPS)
        counters, launches = execute.counters(), ops.launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tr.close()
        with open(log_path) as fh:
            log = [json.loads(line) for line in fh]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(counters == train_attention(cfg, BLOCKGEMM_STEPS)
          and not any(launches.values()),
          f"blockgemm mode dispatched {counters} / launched {launches}, "
          f"want its attention alone on the plain route")
    losses = [m["loss"] for m in log]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, weight["losses"]))
    step_ms = [m["step_time"] * 1e3 for m in log]
    want = weight["losses"][:len(losses)]
    print(f"[blockgemm] losses {[round(x, 5) for x in losses]} against "
          f"weight mode's {[round(x, 5) for x in want]}: rel. diff max "
          f"{rel:.3e} (tol {BLOCKGEMM_TOL:g}); step ms "
          f"{[round(x, 1) for x in step_ms]} (first includes warm-up); "
          f"peak memory {peak_gb:.3f} GB", flush=True)
    check(len(losses) == BLOCKGEMM_STEPS and rel <= BLOCKGEMM_TOL,
          f"blockgemm mode's losses {losses} differ from weight mode's")
    return dict(losses=losses, loss_rel=rel, step_ms=step_ms,
                peak_gb=peak_gb, counters=counters, launches=launches)


def expected_bank_counts(method, cfg, steps, launch_keys):
    """Per run of ``steps`` steps through a bank: each of the 7·L adapted
    linears' bank forward and its remat recompute (ETHER+: two reflection
    calls each), one backward (no dW: PEFT freezes W); the attention's
    (:func:`train_attention`)."""
    n = 7 * cfg.n_layers * steps
    op = BANK_OP[method]
    calls = 2 if method == "etherplus" else 1
    counters = {f"{op}.cuda": 2 * calls * n, f"{op}_bwd.cuda": calls * n}
    # DeLoRA's dx is its bank forward on Wᵀ; HyperAdapt's z and y0 are its
    # bank forward without the column scale
    launches = {"ether": {op: 2 * n, f"{op}_bwd": n},
                "etherplus": {op: 4 * n, f"{op}_bwd": 2 * n},
                "delora": {op: 3 * n},
                "hyperadapt": {op: 4 * n}}[method]
    return ({**counters, **train_attention(cfg, steps)},
            {**dict.fromkeys(launch_keys, 0), **launches})


def phase_bank_train(torch, execute, ops, api, method, single, card):
    """Phase 14: training through a bank.  Phase 4's model, batch (B =
    TRAIN_B, S = TRAIN_S), n_blocks, rank and AdamW, with a bank of
    BANK_TENANTS tenants of ``method`` (each from its own seed, off its
    identity as in phase 12; DeLoRA from b ≠ 0) and ids BANK_TRAIN_IDS,
    TRAIN_STEPS steps through ``steps.make_bank_train_step``, i.e.
    ``train_loss(params, bank.request(ids), ...)``, its gradient over the
    bank's tree and AdamW on it.  Counted (every count set to 0 just
    before the kernels' run, read just after); the plain path on the card
    held to TRAIN_TOL; the tenants no id names keep their rows bitwise and
    get exactly zero gradient rows; a restore from the step-TRAIN_CKPT
    checkpoint of the bank's state ends bitwise equal; then two steps
    traced.  ``single`` is the method's single-tenant activation-mode
    result (phases 4, 6, 8, 10), printed beside this one on ``card``."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.peft import AdapterBank, init_adapters
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.launch import steps as st
    from repro_torch.optim import adamw, cosine

    cfg = get_config(ARCH, "full")
    n_steps, tokens = TRAIN_STEPS, TRAIN_B * TRAIN_S
    print(f"== phase 14: train {ARCH} full width ({cfg.n_layers} layers, "
          f"{cfg.param_dtype}, remat {cfg.remat!r}) through a bank of "
          f"{BANK_TENANTS} {method} tenants (n_blocks={TRAIN_BLOCKS}, rank "
          f"{METHOD_RANK}), B={TRAIN_B} S={TRAIN_S}, ids {BANK_TRAIN_IDS}, "
          f"AdamW lr {TRAIN_LR:g} cosine warmup {TRAIN_WARMUP}, {n_steps} "
          f"steps", flush=True)
    peft = PEFTConfig(method=method, n_blocks=TRAIN_BLOCKS, rank=METHOD_RANK,
                      alpha=float(METHOD_RANK), targets=peft_targets(ARCH))
    params = api.init_model(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    trees = [off_init(torch, init_adapters(
        torch.Generator(device="cuda").manual_seed(100 + t), params, peft),
        BANK_MOVES[method], 1000 + t) for t in range(BANK_TENANTS)]
    bank = AdapterBank.stack(trees, params, peft)
    del trees
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.tensor(BANK_TRAIN_IDS, dtype=torch.int32, device="cuda")
    named = sorted(set(BANK_TRAIN_IDS))
    untouched = [t for t in range(BANK_TENANTS) if t not in named]
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=TRAIN_B,
                               seq_len=TRAIN_S, seed=0)
    batches = [{k: torch.from_numpy(v).long().cuda()
                for k, v in stream.batch_at(i).items()}
               for i in range(n_steps + 2)]
    opt = adamw(cosine(TRAIN_LR, n_steps, TRAIN_WARMUP))

    def snapshot(tree):
        return {p: t.detach().clone() for p, t in flatten_with_paths(tree)}

    def run(backend, state, first, last, mgr=None):
        """Steps first..last−1 from ``state``: (state, losses, grad norms,
        step ms), each step timed on the host to its metrics' read-back;
        with ``mgr``, the bank's state saved after step TRAIN_CKPT."""
        step = st.make_bank_train_step(
            cfg, dataclasses.replace(peft, backend=backend), opt, bank)
        losses, norms, ms = [], [], []
        for i in range(first, last):
            t = time.perf_counter()
            state, m = step(state, batches[i], ids)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            ms.append((time.perf_counter() - t) * 1e3)
            if mgr is not None and i + 1 == TRAIN_CKPT:
                mgr.save(i + 1, {k: state[k] for k in
                                 ("bank", "opt_state", "step")}, block=True)
        return state, losses, norms, ms

    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bank_")
    try:
        init = snapshot(bank.tree)
        mgr = CheckpointManager(tmp)
        # the main path, counted: every count set to 0 just before it
        execute.reset_counters()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        state, losses, norms, step_ms = run(
            "auto", st.make_bank_state(params, bank, opt), 0, n_steps, mgr)
        counters, launches = execute.counters(), ops.launches()
        dx_routes = ops.routes("householder_gemm_batched_bwd")
        bank_routes = ops.routes("householder_gemm_batched")
        ha_routes = ops.routes("hyperadapt_gemm_batched")
        dl_routes = ops.routes("delora_gemm_batched")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        final = {k: snapshot(state[k]) for k in ("bank", "opt_state")}
        final_step = state["step"].clone()
        want = expected_bank_counts(method, cfg, n_steps, ops.launches())
        print(f"[kernels] dispatch counters: {counters}  kernel launches: "
              f"{launches}")
        check((counters, launches) == want,
              f"bank train path ran {counters} / launched {launches}, want "
              f"{want[0]} / {want[1]} (forward + remat recompute + backward "
              f"of {7 * cfg.n_layers} linears a step through the bank "
              f"kernels, no plain version, no dW; attention on the plain "
              f"route under autograd)")
        check_dx_routes(dx_routes, launches, "householder_gemm_batched_bwd",
                        "kernels")
        if launches["householder_gemm_batched"]:
            # S = TRAIN_S rows a sequence, bf16: the forward and its remat
            # recompute all on the wgmma route
            check_dx_routes(bank_routes, launches, "householder_gemm_batched",
                            "kernels")
        if launches["hyperadapt_gemm_batched"]:
            # bf16: the forward, its remat recompute and the backward's z
            # and y0 all on the wgmma route
            check_dx_routes(ha_routes, launches, "hyperadapt_gemm_batched",
                            "kernels")
        if launches["delora_gemm_batched"]:
            # bf16, r = METHOD_RANK: the forward, its remat recompute and
            # the backward's dx all on the wgmma route
            check_dx_routes(dl_routes, launches, "delora_gemm_batched",
                            "kernels")
        check(all(map(math.isfinite, losses + norms)),
              f"bank train losses {losses} / grad norms {norms} not finite")
        steady_ms = sum(step_ms[1:]) / max(len(step_ms) - 1, 1)
        print(f"[kernels] losses {[round(x, 4) for x in losses]}, grad norms "
              f"{[round(x, 4) for x in norms]}; step ms "
              f"{[round(x, 1) for x in step_ms]} (first includes warm-up); "
              f"steady {steady_ms:.1f} ms = {tokens / steady_ms * 1e3:.0f} "
              f"tokens/s; peak memory {peak_gb:.3f} GB; bank "
              f"{bank.size_bytes() / 1e6:.1f} MB built in {build_s:.1f} s")

        # the plain path on the card, outside the counted run
        ref_state, ref_losses, ref_norms, ref_ms = run(
            "torch", st.make_bank_state(params, bank, opt), 0, n_steps)
        ref_final = snapshot(ref_state["bank"])
        del ref_state
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           ref_losses))
        gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(norms, ref_norms))
        num = sum(((final["bank"][p] - init[p]) - (ref_final[p] - init[p]))
                  .float().square().sum().item() for p in init)
        den = sum((ref_final[p] - init[p]).float().square().sum().item()
                  for p in init)
        upd_rel = math.sqrt(num / den)
        print(f"[plain] losses {[round(x, 4) for x in ref_losses]}; steady "
              f"{sum(ref_ms[1:]) / max(len(ref_ms) - 1, 1):.1f} ms/step")
        print(f"kernels vs plain path: loss rel. diff max {loss_rel:.3e} (tol "
              f"{TRAIN_TOL['loss']:g}), grad_norm rel. diff max "
              f"{gnorm_rel:.3e} (tol {TRAIN_TOL['grad_norm']:g}), bank "
              f"update rel. Frobenius {upd_rel:.3e} (tol "
              f"{TRAIN_TOL['update']:g})")
        check(loss_rel <= TRAIN_TOL["loss"]
              and gnorm_rel <= TRAIN_TOL["grad_norm"]
              and upd_rel <= TRAIN_TOL["update"],
              "the kernels' bank training path disagrees with the plain path")

        # the tenants no id names: rows unmoved, and exactly zero gradient
        # rows at the final bank (one more backward, outside the counted
        # run)
        from repro_torch.core.peft import _flatten_adapter_modules
        nds = {f"{mod}/{k}": bank.stack_ndims[mod]
               for mod, a in _flatten_adapter_modules(bank.tree) for k in a}
        sel = torch.tensor(untouched, device="cuda")
        moved = [p for p, t in final["bank"].items()
                 if not torch.equal(t.index_select(nds[p], sel),
                                    init[p].index_select(nds[p], sel))]
        cur = AdapterBank(state["bank"], bank.tenants, bank.stack_ndims)
        loss, _ = api.train_loss(state["params"], cur.request(ids),
                                 batches[n_steps], cfg, peft)
        leaves = flatten_with_paths(state["bank"])
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        nonzero = [p for (p, _), gr in zip(leaves, grads)
                   if gr.index_select(nds[p], sel).abs().max().item() != 0]
        named_zero = [p for (p, _), gr in zip(leaves, grads)
                      if gr.abs().max().item() == 0]
        del grads, loss
        print(f"untouched tenants ({len(untouched)} of {BANK_TENANTS}): "
              f"{len(moved)} leaves moved, {len(nonzero)} leaves with a "
              f"nonzero gradient row; named tenants' gradients zero in "
              f"{len(named_zero)} leaves")
        check(not moved and not nonzero and not named_zero,
              f"untouched tenants moved {moved[:3]} / nonzero gradient rows "
              f"{nonzero[:3]}; all-zero gradients {named_zero[:3]}")

        # restore from the step-TRAIN_CKPT checkpoint of the bank's state
        # and run to the end again
        restored, _ = mgr.restore(TRAIN_CKPT, template={
            k: state[k] for k in ("bank", "opt_state", "step")})
        mgr.close()
        res, res_losses, _, _ = run("auto", dict(restored, params=params),
                                    TRAIN_CKPT, n_steps)
        mism = [f"{k}/{p}" for k in ("bank", "opt_state")
                for p, t in flatten_with_paths(res[k])
                if not torch.equal(t, final[k][p])]
        check(not mism and torch.equal(res["step"], final_step)
              and res_losses == losses[TRAIN_CKPT:],
              f"the restored bank run differs from the uninterrupted one: "
              f"{mism[:5]}")
        print(f"restore from step {TRAIN_CKPT} -> {n_steps}: bank, "
              f"optimizer state and step bitwise equal, losses equal")
        del res

        # the step under torch.profiler, outside the counted runs
        box = {"state": state}

        def two_steps():
            box["state"] = run("auto", box["state"], n_steps, n_steps + 2)[0]
            torch.cuda.synchronize()
        trace = trace_steps(torch, two_steps, 2)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    print_trace(f"{method} bank train", trace, steady_ms)
    print(f"[{method}] bank vs single-tenant activation step on {card}: "
          f"{steady_ms:.1f} vs {single['steady_ms']:.1f} ms, "
          f"{tokens / steady_ms * 1e3:.0f} vs {single['tokens_per_s']:.0f} "
          f"tokens/s, device busy {trace['device_busy_ms']:.1f} vs "
          f"{single['trace']['device_busy_ms']:.1f} ms a step, host ops "
          f"{sum(trace['top_level_ops'].values()):.0f} vs "
          f"{sum(single['trace']['top_level_ops'].values()):.0f} a step, "
          f"peak {peak_gb:.3f} vs {single['peak_gb']:.3f} GB", flush=True)
    return dict(steps=n_steps, ids=BANK_TRAIN_IDS, losses=losses,
                plain_losses=ref_losses, grad_norms=norms,
                plain_grad_norms=ref_norms, step_ms=step_ms,
                steady_ms=steady_ms, plain_step_ms=ref_ms,
                tokens_per_s=tokens / steady_ms * 1e3, peak_gb=peak_gb,
                bank_bytes=bank.size_bytes(), build_s=build_s,
                loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
                update_rel=upd_rel, counters=counters, launches=launches,
                dx_routes=dx_routes, bank_routes=bank_routes,
                ha_routes=ha_routes, dl_routes=dl_routes, trace=trace)


def print_modes(weight, activation, card):
    """Phase 13's step beside the same method's activation-mode step
    (phases 4, 6, 8, 10), on ``card`` (nvidia-smi's name and power
    limit)."""
    print(f"== phase 13: weight vs activation mode on {card}", flush=True)
    for method, w in weight.items():
        a = activation[method]
        print(f"[{method}] weight vs activation mode: step "
              f"{w['steady_ms']:.1f} vs {a['steady_ms']:.1f} ms, "
              f"{w['tokens_per_s']:.0f} vs {a['tokens_per_s']:.0f} tokens/s,"
              f" device busy {w['trace']['device_busy_ms']:.1f} vs "
              f"{a['trace']['device_busy_ms']:.1f} ms a step, peak "
              f"{w['peak_gb']:.3f} vs {a['peak_gb']:.3f} GB", flush=True)


def registry_operands(torch, dtype, gen):
    """The fourteen forward ops' operands at one full-width shape: one
    smollm-360m train layer's gate_proj (x (TRAIN_B, TRAIN_S, 960) in
    ``dtype``, w 960×2560), TRAIN_BLOCKS blocks (db 30; db_out 80),
    DeLoRA's rank METHOD_RANK, banks of BANK_TENANTS tenants with ids
    BANK_TRAIN_IDS; every adapter off its identity (ETHER+ v apart from u,
    DeLoRA b ≠ 0, HyperAdapt r, c about 1).  Returns op → (operands, the
    positions that train: x and the adapters, the JAX suites'
    TRAINABLE_ARGS; w stays frozen)."""
    from repro_torch.core.transforms import resolve_blocks
    dt = getattr(torch, dtype)
    d, f = REGISTRY_LINEAR
    n, r, a = TRAIN_BLOCKS, METHOD_RANK, BANK_TENANTS
    n_out = resolve_blocks(n, f)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x, w = randn(TRAIN_B, TRAIN_S, d).to(dt), (randn(d, f) / d ** .5).to(dt)
    ids = torch.tensor(BANK_TRAIN_IDS, dtype=torch.int32, device="cuda")
    u, v = randn(n, d // n), randn(n, d // n)
    u2, v2 = randn(n_out, f // n_out), randn(n_out, f // n_out)
    ub, vb = randn(a, n, d // n), randn(a, n, d // n)
    am, bm = randn(d, r), randn(r, f)
    sm = (randn(r).abs() + 0.1).to(dt)
    ab, bb = randn(a, d, r), randn(a, r, f)
    sb = (randn(a, r).abs() + 0.1).to(dt)
    rr, cc = 1 + HA_SPREAD * randn(d), 1 + HA_SPREAD * randn(f)
    rb, cb = 1 + HA_SPREAD * randn(a, d), 1 + HA_SPREAD * randn(a, f)
    return {
        "ether_reflect": ((x, u), (0, 1)),
        "ether_reflect_batched": ((x, ub, ids), (0, 1)),
        "householder_gemm": ((x, w, u), (0, 2)),
        "ether_merge": ((w, u), (1,)),
        "etherplus_gemm": ((x, w, u, v, u2, v2), (0, 2, 3, 4, 5)),
        "etherplus_merge": ((w, u, v, u2, v2), (1, 2, 3, 4)),
        "delora_gemm": ((x, w, am, bm, sm), (0, 2, 3, 4)),
        "delora_merge": ((w, am, bm, sm), (1, 2, 3)),
        "hyperadapt_gemm": ((x, w, rr, cc), (0, 2, 3)),
        "hyperadapt_merge": ((w, rr, cc), (1, 2)),
        "householder_gemm_batched": ((x, w, ub, ids), (0, 2)),
        "etherplus_reflect_batched": ((x, ub, vb, ids), (0, 1, 2)),
        "delora_gemm_batched": ((x, w, ab, bb, sb, ids), (0, 2, 3, 4)),
        "hyperadapt_gemm_batched": ((x, w, rb, cb, ids), (0, 2, 3)),
    }


def phase_registry(torch, execute, ops):
    """Phase 16, the registry: each of the fourteen forward ops of
    ``execute.FUNCTIONS`` dispatched on ``cuda`` under autograd, at
    registry_operands' shape, bf16 and f32, with x and the adapters
    requiring grad; a scalar loss (the output against a fixed probe) and
    ``backward()``.  Counted from 0 just before each op's run and read
    just after it: ``<op>.cuda`` and ``<op>_bwd.cuda`` once each, no
    ``.torch`` call, an output with a grad_fn.  Then the same on the
    ``torch`` backend on the card: the output and every gradient to the
    tolerance phase 2 holds the op's kernels to (normalised max error:
    TOL, METHOD_TOL for DeLoRA and HyperAdapt; in f32 the reflections'
    adapter gradients also by relative Frobenius to DU_TOL; in bf16 a
    composite backward rounds recomputed intermediates, y0 and dy0, where
    a flip can fall differently, so there TOL holds them).  Last,
    ``ssd_chunked`` under grad on ``cuda`` must raise NotPortedError."""
    from repro_torch import NotPortedError
    from repro_torch.kernels import batched as kb
    from repro_torch.kernels import hyperadapt_gemm as kh
    print(f"== phase 16: the registry, {len(execute.FUNCTIONS)} forward ops "
          f"dispatched on cuda under autograd at {REGISTRY_LINEAR[0]}×"
          f"{REGISTRY_LINEAR[1]}, B={TRAIN_B} S={TRAIN_S}, n={TRAIN_BLOCKS}, "
          f"A={BANK_TENANTS}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    launches = dict.fromkeys(ops.launches(), 0)
    results = []
    for dtype in ("bfloat16", "float32"):
        operands = registry_operands(torch, dtype, gen)
        check(sorted(operands) == sorted(execute.FUNCTIONS),
              f"phase 16 drives {sorted(operands)}, the registry has "
              f"Functions for {sorted(execute.FUNCTIONS)}")
        for op, (args, train) in operands.items():
            probe, got = None, {}
            for backend in ("cuda", "torch"):
                leaves = [a.detach().clone().requires_grad_(i in train)
                          for i, a in enumerate(args)]
                execute.reset_counters()
                ops.reset_launches()
                t0 = time.perf_counter()
                out = execute.dispatch(op, backend, *leaves)
                if probe is None:
                    probe = torch.randn(out.shape, generator=gen,
                                        device="cuda")
                (out.float() * probe).sum().backward()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                counts, lc = execute.counters(), ops.launches()
                check(out.grad_fn is not None,
                      f"dispatch({op!r}, {backend!r}) under grad gave an "
                      f"output without grad_fn")
                check(counts == {f"{op}.{backend}": 1,
                                 f"{op}_bwd.{backend}": 1},
                      f"{op} on {backend} under autograd counted {counts}")
                if backend == "cuda":
                    check(sum(lc.values()) > 0, f"{op} launched no kernel")
                    for k, c in lc.items():
                        launches[k] += c
                    cuda_launches = {k: c for k, c in lc.items() if c}
                    cuda_ms = wall
                    # the scaled wgmma core's kernels: every launch (the
                    # forward and the backward's z and y0, or dx) on its
                    # rule's route (f32: simt)
                    dt = getattr(torch, dtype)
                    for kernel, rule in (
                            ("hyperadapt_gemm_batched",
                             kb.hyperadapt_route(dt, *REGISTRY_LINEAR,
                                                 True)),
                            ("hyperadapt_gemm",
                             kh.route(dt, *REGISTRY_LINEAR, True)),
                            ("delora_gemm_batched",
                             kb.delora_route(dt, *REGISTRY_LINEAR,
                                             METHOD_RANK, True))):
                        if lc[kernel]:
                            check_fwd_routes(ops.routes(kernel), {
                                **dict.fromkeys(ops.routes(kernel), 0),
                                f"{kernel}.{rule}": lc[kernel]}, kernel,
                                f"registry {op} {dtype}")
                got[backend] = (out.detach(), [leaves[i].grad for i in train])
            (y, dk), (py, dp) = got["cuda"], got["torch"]
            method_op = op.startswith(("delora", "hyperadapt"))
            tol = (METHOD_TOL if method_op else TOL)[dtype]
            errs = [(g.float() - p.float()).abs().max().item()
                    / p.float().abs().max().item()
                    for g, p in zip([y, *dk], [py, *dp])]
            fr = max((frob(g, p) for g, p in zip(dk, dp)), default=0.0) if (
                dtype == "float32" and not method_op) else 0.0
            check(max(errs) <= tol and fr <= DU_TOL,
                  f"{op} on cuda under autograd disagrees with the torch "
                  f"route at {dtype}: output and gradients {errs} (tol "
                  f"{tol:g}), adapter gradients {fr:.3e} (tol {DU_TOL:g})")
            results.append(dict(op=op, dtype=dtype, rel_err=max(errs),
                                grads_rel_err=errs[1:], du_rel_frob=fr,
                                tol=tol, launches=cuda_launches,
                                wall_ms=cuda_ms))
            print(f"  {op:26s} {dtype:8s} grads {len(train)}  err "
                  f"{max(errs):.2e} (tol {tol:g})  du {fr:.2e}  launches "
                  f"{cuda_launches}", flush=True)
    xv = torch.randn(TRAIN_B, 32, 4, 8, generator=gen, device="cuda",
                     requires_grad=True)
    a = -torch.rand(TRAIN_B, 32, 4, generator=gen, device="cuda")
    bc = torch.randn(TRAIN_B, 32, 1, 16, generator=gen, device="cuda")
    execute.reset_counters()
    try:
        execute.dispatch("ssd_chunked", "cuda", xv, a, bc, bc, chunk=32)
        refused = False
    except NotPortedError:
        refused = True
    check(refused and execute.counters() == {},
          "ssd_chunked under grad on cuda did not raise NotPortedError")
    print("  ssd_chunked under grad on cuda: NotPortedError, no call counted",
          flush=True)
    return {"ops": results, "launches": launches}


def main() -> int:
    # before CUDA starts: cuBLAS picks deterministic kernels (phases 4, 6)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.core import execute
    from repro_torch.kernels import batched as kb
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import ether_reflect as ker
    from repro_torch.kernels import ether_reflect_bwd as kerb
    from repro_torch.kernels import etherplus_merge as kepm
    from repro_torch.kernels import etherplus_reflect_bwd as krb
    from repro_torch.kernels import merge_bwd as kmb
    from repro_torch.kernels import reflect_gemm_dw as kdw
    from repro_torch.kernels import reflect_gemm_dx as kdx
    from repro_torch.launch import serve
    from repro_torch.models import api

    t0 = time.perf_counter()
    seconds = {}                        # wall seconds of each phase

    def timed(name, run):
        t = time.perf_counter()
        out = run()
        seconds[name] = time.perf_counter() - t
        return out

    smi = timed("1 build", lambda: phase_device_and_build(torch, build))
    rows = timed("2 rows", lambda: phase_kernels(torch, ops, ref))
    rows += timed("2 etherplus rows",
                  lambda: etherplus_kernel_rows(torch, ops, ref, kepm))
    rows += timed("2 backward rows",
                  lambda: bwd_kernel_rows(torch, ops, ref, kdx, kdw, krb))
    rows += timed("2 method rows", lambda: method_kernel_rows(torch, ops, ref))
    rows += timed("2 bank rows", lambda: bank_kernel_rows(torch, ops, ref))
    rows += timed("2 merge backward rows",
                  lambda: merge_bwd_rows(torch, ops, ref, kmb))
    rows += timed("2 bank backward rows",
                  lambda: bank_bwd_rows(torch, ops, ref, kb))
    rows += timed("2 wide backward rows",
                  lambda: wide_bwd_rows(torch, ops, ref, kdx, kb))
    rows += timed("2 ssd rows", lambda: ssd_kernel_rows(torch, ops, ref))
    rows += timed("2 reflect rows",
                  lambda: reflect_kernel_rows(torch, ops, ref, ker, kerb))
    rows += timed("2 flash rows", lambda: flash_kernel_rows(torch, ops, ref))
    host = timed("2 host cost", lambda: host_cost(torch, ops, execute))
    served = timed("3", lambda: phase_serve(torch, execute, ops, serve, api))
    trained = timed("4", lambda: phase_train(torch, execute, ops, 4, "ether"))
    ep_served = timed("5", lambda: phase_serve_method(
        torch, execute, ops, serve, api, 5, "etherplus"))
    ep_trained = timed("6", lambda: phase_train(torch, execute, ops, 6,
                                                "etherplus"))
    served_m, trained_m = {}, {}
    for phase, method in ((7, "delora"), (9, "hyperadapt")):
        served_m[method] = timed(str(phase), lambda: phase_serve_method(
            torch, execute, ops, serve, api, phase, method))
        trained_m[method] = timed(str(phase + 1), lambda: phase_train(
            torch, execute, ops, phase + 1, method))
    baselines = timed("11", lambda: phase_baselines(torch, execute, ops,
                                                    serve))
    served_bank = {method: timed(f"12 {method}", lambda: phase_serve_bank(
        torch, execute, ops, serve, api, method)) for method in BANK_OP}
    trained_w = {method: timed(f"13 {method}", lambda: phase_train(
        torch, execute, ops, 13, method, "weight", *WEIGHT_STEPS[method],
        moved_off_init(torch, method))) for method in WEIGHT_STEPS}
    blockgemm = {method: timed(f"13 {method} blockgemm", lambda: (
        phase_blockgemm(torch, execute, ops, method, trained_w[method])))
        for method in ("ether", "etherplus")}
    activation = {"ether": trained, "etherplus": ep_trained, **trained_m}
    print_modes(trained_w, activation, smi)
    trained_bank = {method: timed(f"14 {method}", lambda: phase_bank_train(
        torch, execute, ops, api, method, activation[method], smi))
        for method in BANK_OP}
    mamba = timed("15", lambda: phase_serve_mamba(torch, execute, ops, serve,
                                                 api))
    registry = timed("16", lambda: phase_registry(torch, execute, ops))
    qwen = timed("17", lambda: phase_serve_qwen(torch, execute, ops, serve,
                                               api))

    # each main path's own launches, counted from 0 just before it
    paths = {"ether serve": served["unmerged_launches"],
             "ether merge": served["merged_launches"],
             "ether train": trained["launches"],
             "etherplus serve": ep_served["unmerged_launches"],
             "etherplus merge": ep_served["merged_launches"],
             "etherplus train": ep_trained["launches"]}
    for method in served_m:
        paths.update({f"{method} serve": served_m[method]["unmerged_launches"],
                      f"{method} merge": served_m[method]["merged_launches"],
                      f"{method} train": trained_m[method]["launches"]})
    for method, r in served_bank.items():
        paths.update({f"{method} bank serve": r["bank_launches"],
                      f"{method} bank merge": r["merged_launches"]})
    for method, r in trained_w.items():
        paths[f"{method} weight train"] = r["launches"]
    for method, r in blockgemm.items():
        paths[f"{method} blockgemm train"] = r["launches"]
    for method, r in trained_bank.items():
        paths[f"{method} bank train"] = r["launches"]
    for plen, r in mamba["prompts"].items():
        paths.update({f"mamba2 serve P={plen}": r["unmerged_launches"],
                      f"mamba2 merge P={plen}": r["merged_launches"]})
    paths["registry under autograd"] = registry["launches"]
    paths.update({"qwen2.5-32b serve": qwen["unmerged_launches"],
                  "qwen2.5-32b merge": qwen["merged_launches"]})
    decode = (N_BLOCKS, B, "one smollm-360m decode layer, T=4, n=8")
    weights = (N_BLOCKS, None, "one smollm-360m layer's weights, n=8")
    train = (TRAIN_BLOCKS, TRAIN_B * TRAIN_S,
             "one smollm-360m train layer, T=1024, n=32")
    train_weights = (TRAIN_BLOCKS, None,
                     "one smollm-360m train layer's weights, n=32")
    bank_train = (TRAIN_BLOCKS, TRAIN_B * TRAIN_S,
                  f"one smollm-360m train layer through a bank, B=8 S=128, "
                  f"n=32, A={BANK_TENANTS}")
    # name: (source, the TPU kernel's pallas_call, the layer summed in the
    # kernel table (n, T, what), the rows' other keys)
    table = {
        "householder_gemm": ("householder_gemm",
                             "src/repro/kernels/householder_gemm.py:73",
                             decode, {}),
        "ether_merge": ("ether_merge", "src/repro/kernels/ether_merge.py:42",
                        weights, {}),
        "reflect_gemm_dx": ("reflect_gemm_dx",
                            "src/repro/kernels/gemm_bwd.py:151", train,
                            {"rank": 1}),
        "reflect_gemm_dw": ("reflect_gemm_dw",
                            "src/repro/kernels/gemm_bwd.py:246", train,
                            {"rank": 1}),
        "etherplus_gemm": ("etherplus_gemm",
                           "src/repro/kernels/etherplus_gemm.py:148",
                           decode, {"two_sided": True}),
        "etherplus_merge_left": ("etherplus_merge",
                                 "src/repro/kernels/etherplus_merge.py:64",
                                 weights, {}),
        "etherplus_merge_right": ("etherplus_merge",
                                  "src/repro/kernels/etherplus_merge.py:90",
                                  weights, {}),
        "etherplus_reflect_bwd": ("etherplus_reflect_bwd",
                                  "src/repro/kernels/reflect_bwd.py:161",
                                  train, {"rank": 2}),
        "delora_gemm": ("delora_gemm", "src/repro/kernels/delora_gemm.py:82",
                        (None, B, "one smollm-360m decode layer, T=4, r=8"),
                        {"r": METHOD_RANK}),
        "hyperadapt_gemm": ("hyperadapt_gemm",
                            "src/repro/kernels/hyperadapt_gemm.py:66",
                            (None, B, "one smollm-360m decode layer, T=4"),
                            {}),
        "delora_merge": ("method_merge",
                         "src/repro/kernels/method_merge.py:57",
                         (None, None, "one smollm-360m layer's weights, "
                                      "r=8"), {"r": METHOD_RANK}),
        "hyperadapt_merge": ("method_merge",
                             "src/repro/kernels/method_merge.py:97",
                             (None, None, "one smollm-360m layer's weights"),
                             {}),
        "householder_gemm_batched": (
            "householder_gemm_batched",
            "src/repro/kernels/householder_gemm_batched.py:96",
            (N_BLOCKS, B, f"one smollm-360m decode layer, B=4 S=1, n=8, "
                          f"A={BANK_TENANTS}"), {}),
        "etherplus_reflect_batched": (
            "etherplus_reflect_batched",
            "src/repro/kernels/etherplus_reflect_batched.py:70",
            (N_BLOCKS, B, f"one smollm-360m decode layer (both sides of "
                          f"each linear), B=4 S=1, n=8, A={BANK_TENANTS}"),
            {}),
        "delora_gemm_batched": (
            "delora_gemm_batched", "src/repro/kernels/delora_gemm.py:169",
            (None, B, f"one smollm-360m decode layer, B=4 S=1, r=8, "
                      f"A={BANK_TENANTS}"), {"r": METHOD_RANK}),
        "hyperadapt_gemm_batched": (
            "hyperadapt_gemm_batched",
            "src/repro/kernels/hyperadapt_gemm.py:141",
            (None, B, f"one smollm-360m decode layer, B=4 S=1, "
                      f"A={BANK_TENANTS}"), {}),
        "merge_left_bwd": ("merge_bwd", "src/repro/kernels/merge_bwd.py:146",
                           train_weights, {"rank": 1, "need_dw": False}),
        "merge_right_bwd": ("merge_bwd",
                            "src/repro/kernels/merge_bwd.py:185",
                            train_weights, {}),
        "householder_gemm_batched_bwd": (
            "householder_gemm_batched_bwd",
            "src/repro/kernels/gemm_bwd.py:347", bank_train, {}),
        "householder_gemm_batched_dw": (
            "householder_gemm_batched_dw",
            "src/repro/kernels/gemm_bwd.py:420", bank_train, {}),
        "etherplus_reflect_batched_bwd": (
            "etherplus_reflect_batched_bwd",
            "src/repro/kernels/reflect_bwd_batched.py:147",
            (TRAIN_BLOCKS, TRAIN_B * TRAIN_S,
             f"one smollm-360m train layer through a bank (both sides of "
             f"each linear), B=8 S=128, n=32, A={BANK_TENANTS}"), {}),
        "ether_reflect": ("ether_reflect",
                          "src/repro/kernels/ether_reflect.py:53", train, {}),
        "ether_reflect_batched": (
            "ether_reflect", "src/repro/kernels/ether_reflect_batched.py:71",
            bank_train, {}),
        "ether_reflect_bwd": ("ether_reflect_bwd",
                              "src/repro/kernels/reflect_bwd.py:128", train,
                              {}),
        "ether_reflect_batched_bwd": (
            "ether_reflect_bwd",
            "src/repro/kernels/reflect_bwd_batched.py:108", bank_train, {})}
    kernels = []
    for name, (source, replaces, (n, t, what), match) in table.items():
        s = layer_summary(rows, name, n, t, **match)
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        launches = sum(by_path.values())
        check(launches > 0 or name in ("reflect_gemm_dw",
                                       "householder_gemm_batched_dw"),
              f"no main path launched {name}")
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"] or None,
            "matmul_ms": s["matmul_ms"] or None,
            "shapes": f"sum over the 7 linears of {what}, bf16"
                      + (", two-sided" if match.get("two_sided") else "")
                      + (", rank 1, no dW" if match.get("need_dw") is False
                         else "")}
        if match.get("rank") == 1:          # ETHER+'s rank-2 branch
            r2 = layer_summary(rows, name, n, t, **dict(match, rank=2))
            entry["rank2"] = {k: r2[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            entry["rank2"]["matmul_ms"] = r2["matmul_ms"] or None
        if name in ("delora_gemm", "hyperadapt_gemm", "delora_gemm_batched",
                    "hyperadapt_gemm_batched"):
            # its backward composition, which runs this kernel on Wᵀ
            bw = layer_summary(rows, f"{name}_bwd", None, TRAIN_B * TRAIN_S,
                               **match)
            entry["bwd"] = {"shapes": "sum over the 7 linears of one "
                                      "smollm-360m train layer, T=1024"
                                      + (", B=8 S=128" if "batched" in name
                                         else "") + ", bf16, no dW",
                            **{k: bw[k] for k in (
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "matmul_ms", "max_abs_err")}}
        kernels.append(entry)
    # the SSD kernel: one mamba2-1.3b layer's scan of phase 15's main
    # prefill (P = 600: S = 768 padded, B·H = 4·64), the other S beside it
    ssd = {r["t"]: r for r in rows if r["kernel"] == "ssd_chunk"}
    main_row = ssd[MAMBA_PROMPTS[0]]
    by_path = {p: c["ssd_chunk"] for p, c in paths.items() if c["ssd_chunk"]}
    check(sum(by_path.values()) > 0, "no main path launched ssd_chunk")
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:71",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in ssd.values()),
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
        "library_ms": None, "matmul_ms": None,
        "shapes": f"one mamba2-1.3b layer's scan of the P={MAMBA_PROMPTS[0]} "
                  f"prefill: B·H=4·64, S={main_row['s_padded']} (padded), "
                  f"L={main_row['chunk']}, P=64, N=128, b and c bf16",
        "by_seq": {seq: {k: r[k] for k in ("s_padded", "chunk", "ms",
                                           "plain_ms", "bound_ms",
                                           "bound_by")}
                   for seq, r in ssd.items()}})
    # the flash kernel: one qwen2.5-32b prefill layer's attention of phase
    # 17's main path (B = 2, 40 over 8 heads, S = T = 2048, D = 128), bf16;
    # every other row of phase 2 beside it
    flash = [r for r in rows if r["kernel"] == "flash_attention"]
    main_row = next(r for r in flash if r["dtype"] == "bfloat16"
                    and r["arch"] == FLASH_ROWS[0][0])
    by_path = {p: c["flash_attention"] for p, c in paths.items()
               if c["flash_attention"]}
    check(sum(by_path.values()) > 0, "no main path launched flash_attention")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:76",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in flash),
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
        "matmul_ms": None,
        "shapes": "one qwen2.5-32b prefill layer's attention: B=2, H=40 "
                  "over Hkv=8, S=T=2048, D=128, causal, bf16",
        "by_row": [{k: r[k] for k in ("arch", "dtype", "b", "h", "hkv", "s",
                                      "t", "d", "q_offset", "window",
                                      "route", "empty_rows", "max_abs_err",
                                      "rel_err", "ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by")}
                   for r in flash]})
    # flash_attention's routes (csrc/flash_attention.cu): each serving
    # path's launches by route, and the rows of its prefill and decode
    from repro_torch.kernels import flash_attention as fa
    fa_entry = kernels[-1]
    fa_entry["routes"] = list(fa.ROUTES)
    fa_entry["route_of_main_row"] = main_row["route"]
    fa_entry["routes_by_path"] = {
        "ether serve": served["unmerged_flash_routes"],
        "ether merge": served["merged_flash_routes"],
        "qwen2.5-32b serve": qwen["unmerged_flash_routes"],
        "qwen2.5-32b merge": qwen["merged_flash_routes"]}
    fa_entry["qwen_decode"] = {k: row[k] for row in flash
                               if row["dtype"] == "bfloat16"
                               and row["arch"] == "qwen2.5-32b decode"
                               for k in ("route", "ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "max_abs_err")}
    # householder_gemm's routes (csrc/householder_gemm.cu): each path's
    # launches by route, the rows of qwen2.5-32b's gate/up at its prefill
    # and decode beside the decode layer, and a decode call's host cost
    from repro_torch.kernels import householder_gemm as hh
    hh_entry = next(k for k in kernels if k["name"] == "householder_gemm")
    hh_entry["routes"] = list(hh.ROUTES)
    hh_entry["routes_by_path"] = {
        "ether serve": served["unmerged_routes"],
        "ether train": trained["routes"],
        **{f"mamba2 serve P={plen}": r["unmerged_routes"]
           for plen, r in mamba["prompts"].items()},
        "qwen2.5-32b serve": qwen["unmerged_routes"]}
    for key, t in (("prefill", QWEN_B * QWEN_P), ("qwen_decode", QWEN_B)):
        row = next(r for r in rows if r["kernel"] == "householder_gemm"
                   and r["arch"] == QWEN_ARCH and r["dtype"] == "bfloat16"
                   and (r["d"], r["f"]) == QWEN_LINEARS[QWEN_ARCH][2]
                   and r["t"] == t)
        hh_entry[key] = {k: row[k] for k in (
            "t", "d", "f", "n", "route", "ms", "plain_ms", "matmul_ms",
            "bound_ms", "bound_by", "max_abs_err")}
    hh_entry["host_us"] = host
    # the dXr backwards' routes (csrc/dxr_wgmma.cuh): each train path's
    # launches by route, and the Llama-2-7B rows, where the tensor cores
    # set the pace
    for name, by_path in (
            ("reflect_gemm_dx", {"ether train": trained["dx_routes"],
                                 "etherplus train": ep_trained["dx_routes"]}),
            ("householder_gemm_batched_bwd",
             {"ether bank train": trained_bank["ether"]["dx_routes"]})):
        entry = next(k for k in kernels if k["name"] == name)
        entry["wgmma_core"] = "src/repro_torch/csrc/dxr_wgmma.cuh"
        entry["routes"] = list(kdx.ROUTES)
        entry["routes_by_path"] = by_path
        entry["wide"] = [{k: r[k] for k in (
            "arch", "t", "d", "f", "n", "route", "epilogue", "ms", "plain_ms",
            "matmul_ms", "bound_ms", "bound_by", "max_abs_err")}
            for r in rows if r["kernel"] == name and r["arch"] in WIDE_LINEARS]
    # the forwards of ETHER+ and of the ETHER bank on the wgmma core of
    # csrc/hh_wgmma.cuh: each path's launches by route, and every bf16
    # phase-2 row's route, epilogue and each forced route's ms
    from repro_torch.kernels import etherplus_gemm as kep
    for name, routes, by_path in (
            ("etherplus_gemm", kep.ROUTES,
             {"etherplus serve": ep_served["unmerged_ep_routes"],
              "etherplus train": ep_trained["ep_routes"]}),
            ("householder_gemm_batched", kb.GEMM_ROUTES,
             {"ether bank serve": served_bank["ether"]["bank_bank_routes"],
              "ether bank train": trained_bank["ether"]["bank_routes"]})):
        entry = next(k for k in kernels if k["name"] == name)
        entry["wgmma_core"] = "src/repro_torch/csrc/hh_wgmma.cuh"
        entry["routes"] = list(routes)
        entry["routes_by_path"] = by_path
        entry["by_row"] = [
            {k: r.get(k) for k in ("t", "b", "s", "d", "f", "n", "two_sided",
                                   "route", "epilogue", "route_ms",
                                   "epilogue_ms", "ms",
                                   "matmul_ms", "bound_ms")}
            for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"]
    # HyperAdapt's forwards, through a bank and with one tenant, and the
    # DeLoRA bank's (with their backward GEMMs) on the wgmma core of
    # csrc/scaled_wgmma.cuh: each path's launches by route, and every bf16
    # phase-2 row's route, each forced route's ms and (DeLoRA) the
    # low-rank epilogue's ms both ways with the row tiles that staged
    # (counted on the device) and all row tiles
    from repro_torch.kernels import hyperadapt_gemm as kh
    for name, routes, by_path in (
            ("hyperadapt_gemm_batched", kb.HA_ROUTES,
             {"hyperadapt bank serve":
                  served_bank["hyperadapt"]["bank_ha_routes"],
              "hyperadapt bank train":
                  trained_bank["hyperadapt"]["ha_routes"]}),
            ("hyperadapt_gemm", kh.ROUTES,
             {"hyperadapt serve": served_m["hyperadapt"]["unmerged_hg_routes"],
              "hyperadapt train": trained_m["hyperadapt"]["hg_routes"]}),
            ("delora_gemm_batched", kb.DL_ROUTES,
             {"delora bank serve": served_bank["delora"]["bank_dl_routes"],
              "delora bank train": trained_bank["delora"]["dl_routes"]})):
        entry = next(k for k in kernels if k["name"] == name)
        entry["wgmma_core"] = "src/repro_torch/csrc/scaled_wgmma.cuh"
        entry["routes"] = list(routes)
        entry["routes_by_path"] = by_path
        entry["by_row"] = [
            {k: r.get(k) for k in ("t", "b", "s", "d", "f", "r", "route",
                                   "route_ms", "lowrank_ms", "staged_tiles",
                                   "ms", "matmul_ms", "bound_ms")}
            for r in rows if r["kernel"] in (name, f"{name}_bwd")
            and r["dtype"] == "bfloat16" and r.get("route")]
    # rows 5, 6 and 10-13 at phase 2's train-size rows (T = 2048; a
    # bank's B·S = 16·128): the forwards of the bank, ETHER+, DeLoRA and
    # HyperAdapt train paths, beside torch.matmul
    for name, n, match in (
            ("householder_gemm_batched", N_BLOCKS, {}),
            ("etherplus_gemm", TRAIN_BLOCKS, {"two_sided": True}),
            ("delora_gemm", None, {"r": METHOD_RANK}),
            ("delora_gemm_batched", None, {"r": METHOD_RANK}),
            ("hyperadapt_gemm", None, {}),
            ("hyperadapt_gemm_batched", None, {})):
        bank_b, bank_s = max(BANK_ROWS, key=lambda bs: bs[0] * bs[1])
        t = bank_b * bank_s if "batched" in name else max(ROWS)
        summary = layer_summary(rows, name, n, t, **match)
        entry = next(k for k in kernels if k["name"] == name)
        entry["train_size"] = {
            "shapes": f"sum over the 7 linears of one smollm-360m layer, "
                      f"T={t}"
                      + (f", B={bank_b} S={bank_s}" if "batched" in name
                         else "")
                      + ("" if n is None else f", n={n}") + ", bf16",
            **{k: summary[k] for k in ("ms", "plain_ms", "matmul_ms",
                                       "bound_ms", "bound_by",
                                       "max_abs_err")}}
    check(len(kernels) == 27, f"the kernels line lists {len(kernels)}")
    total_s = time.perf_counter() - t0
    print(f"chip_smoke: phases 1-17 took {total_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "rows": rows, "serve": served,
                   "train": trained, "etherplus_serve": ep_served,
                   "etherplus_train": ep_trained,
                   **{f"{m}_serve": r for m, r in served_m.items()},
                   **{f"{m}_train": r for m, r in trained_m.items()},
                   "baselines": baselines,
                   **{f"{m}_bank_serve": r for m, r in served_bank.items()},
                   **{f"{m}_weight_train": r for m, r in trained_w.items()},
                   **{f"{m}_blockgemm_train": r
                      for m, r in blockgemm.items()},
                   **{f"{m}_bank_train": r for m, r in trained_bank.items()},
                   "mamba2_serve": mamba, "registry": registry,
                   "qwen2p5_32b_serve": qwen, "host_cost": host,
                   "kernels": kernels, "phase_seconds": seconds,
                   "seconds": total_s}, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
