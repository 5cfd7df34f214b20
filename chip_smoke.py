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
   (CUDA events, warmed up, weights rotated past the 50 MB L2).
3. Serve: smollm-360m at full width (32 layers, bf16, random weights from
   a seed) with ETHER n_blocks=8, B=4, P=32, 16 new tokens, through the
   CLI's ``serve`` entry point, unmerged and then merged; asserts that
   every adapted linear ran the CUDA kernels and nothing ran the plain
   versions, holds merged against unmerged and the kernels' path against
   the plain path, and prints prefill ms, decode ms per token and peak
   memory.

Any failure raises and exits non-zero; the last line is the device JSON
object.  Full tables go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
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

    def compare(got, want, dtype):
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        check(rel <= TOL[dtype], f"kernel disagrees with its plain version: "
              f"{rel:.3e} > {TOL[dtype]:g}")
        return err, rel

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


def layer_summary(rows, kernel):
    """Sum over one smollm-360m decode layer's seven linears (T = B = 4,
    bf16, n = 8): the kernel work of one layer of one decode step."""
    pick = [r for r in rows if r["kernel"] == kernel and r["arch"] == ARCH
            and r["dtype"] == "bfloat16" and r["n"] == N_BLOCKS
            and r["t"] in (None, B)]
    out = {k: 0.0 for k in ("ms", "plain_ms", "bound_ms", "matmul_ms")}
    by = {"bytes": 0.0, "operations": 0.0}
    for r in pick:
        mult = LAYER[(r["d"], r["f"])]
        for k in out:
            out[k] += mult * (r[k] or 0.0)
        by[r["bound_by"]] += mult * r["bound_ms"]
    check(sum(LAYER.values()) == sum(LAYER[(r["d"], r["f"])] for r in pick),
          f"{kernel}: missing main-path shapes in the kernel table")
    out["max_abs_err"] = max(r["max_abs_err"] for r in pick)
    out["bound_by"] = max(by, key=by.get)
    return out


def run_path(torch, execute, ops, serve, **kw):
    """Drive one main path through the CLI's ``serve`` entry point with
    every count set to 0 just before it, and read the path's own dispatch
    counters, kernel launches and peak memory just after it."""
    execute.reset_counters()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    r = serve.serve(**kw)
    r["counters"], r["launches"] = execute.counters(), ops.launches()
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return r


def profile_decode(torch, serve, api, steps, **kw):
    """torch.profiler trace of ``steps`` greedy decode steps of the model
    ``serve.build(**kw)`` makes, after as many untimed ones.  Returns, per
    step: the device's busy ms and its busiest kernels, and the host side
    -- wall ms under the profiler, top-level operators (ATen ops, CUDA
    runtime calls such as the ctypes kernel launches, others) and their
    mean CPU µs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m = serve.build(**kw)
    params, adapters, cfg, peft = (m[k] for k in
                                   ("params", "adapters", "cfg", "peft"))
    cache, logits = api.prefill(params, adapters, {"tokens": m["tokens"]},
                                cfg, peft)
    cache = api.pad_cache(cache, cfg, m["tokens"].shape[1] + 2 * steps + 1)

    def decode(tok, cache):
        for _ in range(steps):
            logits, cache = api.decode_step(params, adapters, cache, tok,
                                            cfg, peft)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        return tok, cache

    tok, cache = decode(logits[:, -1].argmax(dim=-1, keepdim=True), cache)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()        # the profiler's start and stop
        decode(tok, cache)              # are left out of the wall time
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = [(e.key, e.self_device_time_total / 1e3 / steps)
           for e in prof.key_averages() if e.self_device_time_total > 0]
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


def phase_serve(torch, execute, ops, serve, api):
    print(f"== phase 3: serve {ARCH} full width, ETHER n_blocks={N_BLOCKS}, "
          f"B={B} P={P} gen={GEN}", flush=True)
    kw = dict(arch=ARCH, variant="full", n_blocks=N_BLOCKS, batch=B,
              prompt_len=P, seed=0, device="cuda")
    un = run_path(torch, execute, ops, serve, backend="auto", gen=GEN, **kw)
    mg = run_path(torch, execute, ops, serve, backend="auto", gen=GEN,
                  merged=True, **kw)

    from repro_torch.configs import get_config
    cfg = get_config(ARCH, "full")
    per_forward = 7 * cfg.n_layers
    # each path's own counts: the unmerged path runs householder_gemm on
    # every adapted linear of every forward and nothing else; the merged
    # path runs ether_merge once per adapted linear and nothing else
    want = {"unmerged": ({"householder_gemm.cuda": per_forward
                          * un["forwards"]},
                         {"householder_gemm": per_forward * un["forwards"],
                          "ether_merge": 0}),
            "merged": ({"ether_merge.cuda": per_forward},
                       {"householder_gemm": 0, "ether_merge": per_forward})}
    for name, r in (("unmerged", un), ("merged", mg)):
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
        t = traces[name] = profile_decode(torch, serve, api, GEN,
                                          merged=r["merge_s"] is not None,
                                          **kw)
        n_ops = sum(t["top_level_ops"].values())
        print(f"[{name}] profiled decode step: wall "
              f"{t['profiled_wall_ms']:.2f} ms, device busy "
              f"{t['device_busy_ms']:.3f} ms (idle "
              f"{100 * (1 - t['device_busy_ms'] / t['profiled_wall_ms']):.1f}"
              f"% of the profiled wall, "
              f"{100 * (1 - t['device_busy_ms'] / (r['per_token_s'] * 1e3)):.1f}"
              f"% of the unprofiled)", flush=True)
        print(f"    host: {n_ops:.1f} top-level ops per step ("
              + ", ".join(f"{k} {n:.1f} x {t['top_level_cpu_us'][k]:.1f} us"
                          for k, n in t["top_level_ops"].items() if n)
              + f"): {t['top_level_cpu_ms']:.2f} ms CPU in them, "
              f"{100 * t['top_level_cpu_ms'] / t['profiled_wall_ms']:.1f}% "
              f"of the profiled wall")
        print("    busiest device work: " + ", ".join(
            f"{k[:48]} {ms:.3f} ms" for k, ms in t["busiest_ms"]))

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


def main() -> int:
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
    from repro_torch.launch import serve
    from repro_torch.models import api

    smi = phase_device_and_build(torch, build)
    rows = phase_kernels(torch, ops, ref)
    served = phase_serve(torch, execute, ops, serve, api)

    replaces = {
        "householder_gemm": "src/repro/kernels/householder_gemm.py:73",
        "ether_merge": "src/repro/kernels/ether_merge.py:42"}
    # each kernel's launches from the run of the path that runs it
    path = {"householder_gemm": "unmerged", "ether_merge": "merged"}
    kernels = []
    for name in ("householder_gemm", "ether_merge"):
        s = layer_summary(rows, name)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": served[path[name] + "_launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "matmul_ms": s["matmul_ms"] if name == "householder_gemm"
            else None,
            "shapes": "sum over one smollm-360m layer's 7 linears, bf16, "
                      "n=8" + (", T=4" if name == "householder_gemm"
                               else "")})
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"card": smi, "rows": rows, "serve": served,
                   "kernels": kernels}, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
