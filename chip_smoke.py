#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py          # from the root of a checkout

1. Device and build: prints the card (nvidia-smi's name and power
   limit), builds the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   each, all at once) and prints their build time and ptxas lines.
2. Kernels: holds each CUDA kernel against its plain PyTorch version on
   the card, at T ∈ {4, 128, 2048} rows and the linears of smollm-360m
   and Llama-2-7B, n ∈ {8, 32} blocks, bf16 and float32, and times the
   kernel, its plain version and ``torch.matmul`` on the same product
   (CUDA events, warmed up, weights rotated past the 50 MB L2).  The
   ETHER+ kernels (``etherplus_gemm`` one- and two-sided, the left and
   right ``etherplus_merge`` kernels) run on adapters whose v is drawn
   apart from u, from their own generator, so the ETHER rows see the
   inputs they always did.
3. Serve: smollm-360m at full width (32 layers, bf16, random weights from
   a seed) with ETHER n_blocks=8, B=4, P=32, 16 new tokens, through the
   CLI's ``serve`` entry point, unmerged and then merged; asserts that
   every adapted linear ran the CUDA kernels and nothing ran the plain
   versions, holds merged against unmerged and the kernels' path against
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
   the device's busy time and the host's top-level ops.
5. Serve ETHER+: phase 3's model and requests with two-sided ETHER+
   (n_blocks 8), its v1/v2 drawn apart from u1/u2 from a seed (the
   method's init has H⁺ = I), through ``serve.generate`` unmerged and
   after ``merge_params``; the same checks, counts and trace as phase 3.
6. Train ETHER+: phase 4 with two-sided ETHER+ (n_blocks 32), from the
   method's own init, through ``Trainer``; the same checks, with the
   ETHER+ backward's counts (the y0 recompute and
   ``etherplus_reflect_bwd`` in every adapted linear's backward).
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
   kernels, held to SERVE_TOL, and every row moved by more than SERVE_TOL
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

Phase 2 also holds ``reflect_gemm_dx`` (dx and du) and ``reflect_gemm_dw``
against their plain versions at T ∈ {1024, 2048} (and a ragged 1000),
rank 1 and, with ETHER+'s v, rank 2, and ``etherplus_reflect_bwd`` on the
output side, and times them beside ``torch.matmul`` of the GEMM inside
each.  For DeLoRA and HyperAdapt it holds ``delora_gemm`` (r ∈ {8, 64})
and ``hyperadapt_gemm`` at the forward rows, ``delora_merge`` and
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

Float32 matmuls run in full f32 (TF32 off) throughout, as the kernels
compute; ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts so that
cuBLAS is deterministic in the train phases.

Any failure raises and exits non-zero; the last line is the device JSON
object, the line before it the kernels' JSON line.  Full tables go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
LINEARS = {"smollm-360m": [(960, 960), (960, 320), (960, 2560), (2560, 960)],
           "llama-2-7b": [(4096, 4096), (4096, 11008), (11008, 4096)]}
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
TRAIN_B, TRAIN_S, TRAIN_BLOCKS, TRAIN_STEPS, TRAIN_CKPT = 8, 128, 32, 8, 4
TRAIN_LR, TRAIN_WARMUP = 2e-3, 2
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


def launched(result):
    """A launcher's outputs after its cudaError_t, which must be 0."""
    check(result[0] == 0, f"launch refused (cudaError_t {result[0]})")
    return result[1:] if len(result) > 2 else result[1]


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOP_S[dtype]
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

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for arch, shapes in LINEARS.items():
            for d, f in shapes:
                w0 = torch.randn(d, f, generator=gen, device="cuda") / d ** .5
                ws = [w0.to(dt).clone() for _ in range(copies(d * f * es))]
                for n in BLOCKS:
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
                    for t in ROWS:
                        x = torch.randn(t, d, generator=gen,
                                        device="cuda").to(dt)
                        err, rel = compare(ops.householder_gemm(x, ws[0], u),
                                           ref.ref_householder_gemm(
                                               x, ws[0], u), dtype)
                        b_ms, b_by = bound(
                            (t * d + d * f + t * f) * es + 4 * d,
                            2 * t * d * f + 4 * t * d, dtype)
                        rows.append(dict(
                            kernel="householder_gemm", arch=arch, dtype=dtype,
                            t=t, d=d, f=f, n=n, max_abs_err=err, rel_err=rel,
                            tol=TOL[dtype],
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
                              "d={d:5d} f={f:5d} n={n:2d} T={t:4d}  err "
                              "{rel_err:.2e} (tol {tol:g})  {ms:.4f} ms  "
                              "plain {plain_ms:.4f} ms  matmul "
                              "{matmul_ms:.4f} ms  bound {bound_ms:.4f} ms "
                              "({bound_by})".format(**rows[-1]), flush=True)
                del ws
    torch.cuda.synchronize()
    return rows


def etherplus_kernel_rows(torch, ops, ref, kepm):
    """Phase 2, ETHER+ forward: etherplus_gemm (two- and one-sided) and
    the left and right etherplus_merge kernels against their plain
    versions, on phase 2's shapes, with v1/v2 drawn apart from u1/u2 (a
    generator of their own).  The merges are held and timed one kernel
    at a time (``kepm``'s launchers; the left one also through the
    wrapper), the GEMM through its wrapper beside ``torch.matmul``."""
    from repro_torch.core.transforms import resolve_blocks
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
                            err, rel = compare(
                                ops.etherplus_gemm(x, w, u1, v1, *out),
                                ref.ref_etherplus_gemm(x, w, u1, v1, *out),
                                dtype, "etherplus_gemm")
                            b_ms, b_by = bound(
                                (t * d + d * f + t * f) * es + 8 * d
                                + (8 * f if two else 0),
                                2 * t * d * f + 8 * t * d
                                + (8 * t * f if two else 0), dtype)
                            rows.append(dict(
                                common, kernel="etherplus_gemm", t=t,
                                two_sided=two, max_abs_err=err, rel_err=rel,
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
                                  "T={t:4d}  err {rel_err:.2e} (tol {tol:g})"
                                  "  {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                                  "matmul {matmul_ms:.4f} ms  bound "
                                  "{bound_ms:.4f} ms ({bound_by})".format(
                                      s="2s" if two else "1s", **rows[-1]),
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
                kernel="reflect_gemm_dx", **common, max_abs_err=max(
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
        dict(common, kernel="reflect_gemm_dx",
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


def method_kernel_rows(torch, ops, ref):
    """Phase 2, DeLoRA and HyperAdapt: delora_gemm (r ∈ METHOD_RANKS) and
    hyperadapt_gemm at the forward rows, delora_merge and hyperadapt_merge
    on the weights, and the backward compositions delora_gemm_bwd and
    hyperadapt_gemm_bwd (no dW: PEFT) at the backward rows, each through
    its wrapper against its plain version, timed beside it and beside
    ``torch.matmul`` of the GEMM inside (``torch.addmm`` for
    delora_merge).  Every operand is off the methods' identity init (b ≠
    0, r and c ≠ 1), from a generator of its own."""
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
              + "bound {bound_ms:.4f} ms ({bound_by})".format(**row),
              flush=True)

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
                    add("hyperadapt_gemm", dtype,
                        [(ops.hyperadapt_gemm(x, w, rr, c),
                          ref.ref_hyperadapt_gemm(x, w, rr, c))],
                        t=t, r=None, **common, matmul_ms=mm,
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
            add("hyperadapt_gemm_bwd", dtype,
                [(p, q) for p, q in zip(got, want) if q is not None],
                r=None, **common,
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
    two calls."""
    from repro_torch.core.transforms import resolve_blocks
    print("== phase 2: bank kernels against their plain versions "
          f"(A={BANK_TENANTS}, ids {BANK_IDS})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
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
              "{bound_ms:.4f} ms ({bound_by})".format(**row), flush=True)

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
                add("householder_gemm_batched", dtype, got,
                    ref.ref_householder_gemm_batched(x, w, u, ids), n=N_BLOCKS,
                    r=None, **common,
                    ms=timed_ms(torch, [
                        lambda w=w: ops.householder_gemm_batched(x, w, u, ids)
                        for w in ws]),
                    plain_ms=timed_ms(torch, [
                        lambda w=w: ref.ref_householder_gemm_batched(
                            x, w, u, ids) for w in ws]),
                    **dict(zip(("bound_ms", "bound_by"), bound(
                        io + 4 * d * tenants,
                        2 * m * d * f + 4 * m * d, dtype))))
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
                    add("delora_gemm_batched", dtype,
                        ops.delora_gemm_batched(x, w, ab, bb, sb, ids),
                        ref.ref_delora_gemm_batched(x, w, ab, bb, sb, ids),
                        n=None, r=r, **common,
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
                add("hyperadapt_gemm_batched", dtype,
                    ops.hyperadapt_gemm_batched(x, w, rb, cb, ids),
                    ref.ref_hyperadapt_gemm_batched(x, w, rb, cb, ids),
                    n=None, r=None, **common,
                    ms=timed_ms(torch, [
                        lambda w=w: ops.hyperadapt_gemm_batched(
                            x, w, rb, cb, ids) for w in ws]),
                    plain_ms=timed_ms(torch, [
                        lambda w=w: ref.ref_hyperadapt_gemm_batched(
                            x, w, rb, cb, ids) for w in ws]),
                    **dict(zip(("bound_ms", "bound_by"), bound(
                        io + 4 * (d + f) * tenants,
                        2 * m * d * f + m * (d + f), dtype))))
            del ws, w
    torch.cuda.synchronize()
    return rows


def merge_bwd_rows(torch, ops, ref, kmb):
    """Phase 2, weight mode: merge_left_bwd (rank 1 and 2, with and
    without dW) and merge_right_bwd (ETHER+'s output side, n_out =
    resolve_blocks(n, f): db_out 10, 30, 80 at smollm-360m's linears and
    n = 32, 1,376 at Llama-2-7B's gate/up and n = 8) through their
    wrappers against their plain versions, on phase 2's linears with v
    drawn apart from u, then timed through their launchers (``kmb``)
    beside their plain versions, rotating (W, G) pairs past the L2.  The
    left kernel keeps its strips of W and G in shared memory up to db 160
    in f32, 320 in bf16, and re-reads them past that: smollm-360m's
    down_proj at n = 8 (db 320) in f32 and Llama-2-7B's linears at n = 8
    (db 512, 1,376) take the re-read branch."""
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
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return r


def trace_steps(torch, run, steps):
    """torch.profiler trace of ``run()``, which runs ``steps`` steps and
    synchronises.  Returns, per step: the device's busy ms and its
    busiest kernels, and the host side -- wall ms under the profiler,
    top-level operators (ATen ops, CUDA runtime calls such as the ctypes
    kernel launches, others) and their mean CPU µs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()        # the profiler's start and stop
        run()                           # are left out of the wall time
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device work: the kernels and copies themselves.  A CPU op's (and a
    # record_function range's) self device time repeats the time of the
    # kernels it launched, so summing every event would count them twice
    dev = [(e.key, e.self_device_time_total / 1e3 / steps)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.self_device_time_total > 0]
    top = {"aten": [], "cuda runtime": [], "other": []}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            kind = ("aten" if e.name.startswith("aten::") else "cuda runtime"
                    if e.name.startswith("cuda") else "other")
            top[kind].append(e.cpu_time_total)
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": sum(t for _, t in dev),
            "busiest_ms": sorted(dev, key=lambda r: -r[1])[:6],
            "top_level_ops": {k: len(v) / steps for k, v in top.items()},
            "top_level_cpu_us": {k: sum(v) / max(len(v), 1)
                                 for k, v in top.items()},
            "top_level_cpu_ms": sum(map(sum, top.values())) / 1e3 / steps}


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
        f"{k[:48]} {ms:.3f} ms" for k, ms in t["busiest_ms"]))


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


def check_served(torch, cfg, runs, want):
    """Hold each served path's counts to ``want[name]`` (dispatch
    counters, kernel launches) and its outputs to their shapes; print its
    times."""
    for name, r in runs.items():
        print(f"[{name}] dispatch counters: {r['counters']}  kernel "
              f"launches: {r['launches']}")
        check((r["counters"], r["launches"]) == want[name],
              f"{name} path ran {r['counters']} / launched "
              f"{r['launches']}, want {want[name][0]} / {want[name][1]} "
              f"({r['forwards']} forwards, no plain version)")
        check(tuple(r["logits"].shape) == (B, 1, cfg.vocab)
              and r["logits"].dtype == torch.float32
              and bool(torch.isfinite(r["logits"]).all()),
              f"{name} logits are not finite (B, 1, V) float32")
        check(tuple(r["tokens"].shape) == (B, GEN + 1),
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
    # every adapted linear of every forward and nothing else; the merged
    # path runs ether_merge once per adapted linear and nothing else
    none = dict.fromkeys(ops.launches(), 0)
    want = {"unmerged": ({"householder_gemm.cuda": per_forward
                          * un["forwards"]},
                         {**none, "householder_gemm": per_forward
                          * un["forwards"]}),
            "merged": ({"ether_merge.cuda": per_forward},
                       {**none, "ether_merge": per_forward})}
    check_served(torch, cfg, {"unmerged": un, "merged": mg}, want)
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

    w_bytes = 2 * cfg.n_layers * sum(m * d * f for (d, f), m in LAYER.items())
    print(f"decode-step bound from reading the adapted weights: "
          f"{w_bytes / 1e6:.0f} MB / 3.35 TB/s = "
          f"{w_bytes / HBM_BYTES_S * 1e3:.3f} ms")
    return dict(merged_vs_unmerged=merged_err, kernels_vs_plain=plain_err,
                token_agreement=agree(mg["tokens"], un["tokens"]),
                weights_bytes=w_bytes,
                **{f"{name}_{k}": r[k] for name, r in
                   (("unmerged", un), ("merged", mg))
                   for k in ("prefill_s", "per_token_s", "peak_gb",
                             "forwards", "merge_s", "counters", "launches")},
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
    want = {"unmerged": ({f"{method}_gemm.cuda": per_forward
                          * un["forwards"]},
                         {**none, f"{method}_gemm": per_forward
                          * un["forwards"]}),
            "merged": ({f"{method}_merge.cuda": per_forward},
                       {**none, **dict.fromkeys(merges, per_forward)})}
    check_served(torch, cfg, {"unmerged": un, "merged": mg}, want)

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
                             "forwards", "merge_s", "counters", "launches")},
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
    want = {"bank": ({f"{op}.cuda": per_forward * bk["forwards"]},
                     {**none, op: per_forward * bk["forwards"]}),
            "merged t=0": ({f"{method}_merge.cuda": 7 * cfg.n_layers},
                           {**none, **dict.fromkeys(merges,
                                                    7 * cfg.n_layers)})}
    check_served(torch, cfg, {"bank": bk, "merged t=0": mg}, want)

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
                             "forwards", "merge_s", "counters", "launches")},
                trace=trace)


def phase_baselines(torch, execute, ops, serve):
    """Phase 11: LoRA, OFT, Naive and full finetuning, plain PyTorch, at
    full width on the card: a short serve (LoRA, OFT, Naive unmerged and
    merged, adapters moved off their init; ``full`` unmerged), then
    BASELINE_STEPS train steps from each method's init through
    ``launch/steps``; nothing may dispatch to a kernel."""
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
            check((r["counters"], r["launches"]) == none,
                  f"{method} {name} ran {r['counters']} / launched "
                  f"{r['launches']}; it has no kernel")
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
        check((execute.counters(), ops.launches()) == none,
              f"{method} training ran {execute.counters()} / launched "
              f"{ops.launches()}; it has no kernel")
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


def expected_train_counts(method, mode, n, launch_keys):
    """Per train run of n = 7·L·steps adapted-linear steps, the dispatch
    counters and kernel launches of ``method`` in ``mode``: each linear's
    forward and its remat recompute, and one backward (no dW: PEFT
    freezes W)."""
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
    return counters, {**dict.fromkeys(launch_keys, 0), **launches}


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
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        final = {k: snapshot(tr.state[k])
                 for k in ("adapters", "opt_state", "step")}
        tr.close()
        log = logged("a")

        # per step, each of the 7·L adapted linears
        n = 7 * cfg.n_layers * steps
        want = expected_train_counts(method, mode, n, ops.launches())
        print(f"[kernels] dispatch counters: {counters}  kernel launches: "
              f"{launches}")
        check((counters, launches) == want,
              f"train path ran {counters} / launched {launches}, want "
              f"{want[0]} / {want[1]} (forward + remat recompute + backward "
              f"of {7 * cfg.n_layers} linears a step, no plain version)")
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
                counters=counters, launches=launches, trace=trace)


def phase_blockgemm(torch, execute, ops, method, weight):
    """Phase 13, blockgemm: ``method`` trained BLOCKGEMM_STEPS steps in
    blockgemm mode (the paper's dense (db × db) blocks and n block GEMMs,
    plain PyTorch as in the JAX package) from the same start
    (:func:`moved_off_init`) and schedule as the weight-mode run
    ``weight``, counted: no kernel op dispatches.  Its per-step losses
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
    check(not counters and not any(launches.values()),
          f"blockgemm mode dispatched {counters} / launched {launches}")
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
    from repro_torch.kernels import build, ops, ref
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
    print_modes(trained_w, {"ether": trained, "etherplus": ep_trained,
                            **trained_m}, smi)

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
    decode = (N_BLOCKS, B, "one smollm-360m decode layer, T=4, n=8")
    weights = (N_BLOCKS, None, "one smollm-360m layer's weights, n=8")
    train = (TRAIN_BLOCKS, TRAIN_B * TRAIN_S,
             "one smollm-360m train layer, T=1024, n=32")
    train_weights = (TRAIN_BLOCKS, None,
                     "one smollm-360m train layer's weights, n=32")
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
                            train_weights, {})}
    kernels = []
    for name, (source, replaces, (n, t, what), match) in table.items():
        s = layer_summary(rows, name, n, t, **match)
        by_path = {p: c[name] for p, c in paths.items() if c[name]}
        launches = sum(by_path.values())
        check(launches > 0 or name == "reflect_gemm_dw",
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
        if name in ("delora_gemm", "hyperadapt_gemm"):
            # its backward composition, which runs this kernel on Wᵀ
            bw = layer_summary(rows, f"{name}_bwd", None, TRAIN_B * TRAIN_S,
                               **match)
            entry["bwd"] = {"shapes": "sum over the 7 linears of one "
                                      "smollm-360m train layer, T=1024, "
                                      "bf16, no dW",
                            **{k: bw[k] for k in (
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "matmul_ms", "max_abs_err")}}
        kernels.append(entry)
    check(len(kernels) == 18, f"the kernels line lists {len(kernels)}")
    total_s = time.perf_counter() - t0
    print(f"chip_smoke: phases 1-13 took {total_s:.1f} s (" + ", ".join(
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
                   "kernels": kernels, "phase_seconds": seconds,
                   "seconds": total_s}, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
