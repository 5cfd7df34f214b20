#!/usr/bin/env python3
"""Layer sums of rows 11-13 (``delora_gemm_batched``, ``hyperadapt_gemm``,
``hyperadapt_gemm_batched``) on two source trees, in turns, on one card.

    python3 tools/layer_pair.py BASE_SRC NEW_SRC [--rounds R]

BASE_SRC and NEW_SRC are the ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this tree).
Each run is a process of its own with that tree's ``src`` on
``PYTHONPATH``, in the order base, new, new, base, R times over.  A run
times, with this repo's ``chip_smoke.py`` constants and its ``timed_ms``
(CUDA events, weights rotated past the L2), each op through the tree's
``ops`` wrapper summed over one smollm-360m layer's seven linears, bf16,
at decode (the bank's B sequences of S = 1; one tenant's T = B rows) and
at train size (the bank's 16 sequences of 128; one tenant's T = 2,048
rows), the banks of BANK_TENANTS tenants read at BANK_IDS, DeLoRA at
rank METHOD_RANK; beside them, ``torch.matmul`` of the same product;
and, where the tree's launchers name routes (``batched.HA_ROUTES``,
``batched.DL_ROUTES``, ``hyperadapt_gemm.ROUTES``), each route forced.
Prints the card's name and power limit, each run's
sums, and last a JSON line with every run and each tree's median.  Exits
non-zero if a run fails.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r"""
import json, sys
import torch
sys.path.append(sys.argv[1])
import chip_smoke as cs
from repro_torch.kernels import batched as kb
from repro_torch.kernels import hyperadapt_gemm as kh
from repro_torch.kernels import ops
gen = torch.Generator(device="cuda").manual_seed(7)

def randn(*shape):
    return torch.randn(*shape, generator=gen, device="cuda")

a_n = cs.BANK_TENANTS
out = {}
for size, (nb, ns) in (("decode", (cs.B, 1)), ("train", (16, 128))):
    ids = torch.tensor(cs.BANK_IDS * (nb // len(cs.BANK_IDS)),
                       dtype=torch.int32, device="cuda")
    sums = {}

    def add(key, mult, fns):
        sums[key] = sums.get(key, 0.0) + mult * cs.timed_ms(torch, fns)

    for (d, f), mult in cs.LAYER.items():
        w0 = randn(d, f) / d ** .5
        ws = [w0.bfloat16().clone() for _ in
              range(max(1, min(256, int(100e6 // (d * f * 2)) + 1)))]
        xb = randn(nb, ns, d).bfloat16()
        rb, cb = 1 + 0.3 * randn(a_n, d), 1 + 0.3 * randn(a_n, f)
        add("hyperadapt_gemm_batched", mult, [
            lambda w=w: ops.hyperadapt_gemm_batched(xb, w, rb, cb, ids)
            for w in ws])
        for on in getattr(kb, "HA_ROUTES", ()):
            add(f"hyperadapt_gemm_batched {on}", mult, [
                lambda w=w, on=on: kb.hyperadapt_gemm_batched(
                    xb, w, rb, cb, ids, on=on) for w in ws])
        add("matmul bank", mult, [lambda w=w: torch.matmul(xb, w)
                                  for w in ws])
        r = cs.METHOD_RANK
        ab, bb = randn(a_n, d, r), randn(a_n, r, f)
        sb = (randn(a_n, r).abs() + 0.1).bfloat16()
        add("delora_gemm_batched", mult, [
            lambda w=w: ops.delora_gemm_batched(xb, w, ab, bb, sb, ids)
            for w in ws])
        for on in getattr(kb, "DL_ROUTES", ()):
            add(f"delora_gemm_batched {on}", mult, [
                lambda w=w, on=on: kb.delora_gemm_batched(
                    xb, w, ab, bb, sb, ids, on=on) for w in ws])
        x1 = xb.view(nb * ns, d)
        r1, c1 = rb[0].contiguous(), cb[0].contiguous()
        add("hyperadapt_gemm", mult, [
            lambda w=w: ops.hyperadapt_gemm(x1, w, r1, c1) for w in ws])
        for on in getattr(kh, "ROUTES", ()):
            add(f"hyperadapt_gemm {on}", mult, [
                lambda w=w, on=on: kh.launch(x1, w, r1, c1, on=on)
                for w in ws])
        del ws
    out[size] = sums
print(json.dumps(out))
"""


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(src: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    out = subprocess.run([sys.executable, "-c", CHILD, REPO],
                         capture_output=True, text=True, env=env, timeout=900)
    if out.returncode:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"the run in {src} failed (exit {out.returncode})")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    runs = []
    for _ in range(args.rounds):
        for name in ("base", "new", "new", "base"):
            r = run(getattr(args, name))
            runs.append({"tree": name, **r})
            print(f"{name:4s}  " + "; ".join(
                f"{size}: " + ", ".join(f"{k} {v:.4f}" for k, v in s.items())
                for size, s in r.items()), flush=True)
    summary = {}
    for name in ("base", "new"):
        mine = [r for r in runs if r["tree"] == name]
        summary[name] = {size: {k: statistics.median(r[size][k] for r in mine)
                                for k in mine[0][size]}
                         for size in mine[0] if size != "tree"}
    print(json.dumps({"card": card(), "runs": runs, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
