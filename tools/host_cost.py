#!/usr/bin/env python3
"""Host cost of a decode step's ``householder_gemm`` calls (or, with
``--op``, ``hyperadapt_gemm``'s, ``hyperadapt_gemm_batched``'s,
``delora_gemm_batched``'s or ``etherplus_reflect_batched``'s) on two
source trees, in turns, on one card.

    python3 tools/host_cost.py BASE_SRC NEW_SRC [--rounds R] [--op OP]

BASE_SRC and NEW_SRC are the ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this tree).
Each run is a process of its own with that tree's ``src`` on
``PYTHONPATH``, in the order base, new, new, base, R times over, so that
a drift of the host during the call falls on both trees alike.  A run
builds its tree's kernel (into that tree's ``_build``) and runs this
repo's ``chip_smoke.host_cost`` on that tree's ``ops`` and ``execute``
(the banks of BANK_TENANTS tenants at S = 1, HyperAdapt's one tenant at
T = B rows; the ETHER+ bank's reflection twice a linear, on its input
and on its output):
whole decode steps of calls through each (at least HOST_CALLS calls),
cycling through a step's adapted linears (smollm-360m's 224, each weight
with its own adapter, each layer's inputs at addresses of their own), each
step timed on the host clock from a synchronize to the return of its
last call.  Prints the card's name and power limit, each run's µs a
call and tensor maps encoded, and last a JSON line with every run and
each tree's median and range.  Exits non-zero if a run fails.
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
import chip_smoke
from repro_torch.core import execute
from repro_torch.kernels import ops
print(json.dumps(chip_smoke.host_cost(torch, ops, execute, sys.argv[2])))
"""
KEYS = ("ops_us", "dispatch_us")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(src: str, op: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    out = subprocess.run([sys.executable, "-c", CHILD, REPO, op],
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
    ap.add_argument("--op", default="householder_gemm",
                    choices=("householder_gemm", "hyperadapt_gemm",
                             "hyperadapt_gemm_batched",
                             "delora_gemm_batched",
                             "etherplus_reflect_batched"))
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    runs = []
    for _ in range(args.rounds):
        for name in ("base", "new", "new", "base"):
            r = run(getattr(args, name), args.op)
            runs.append({"tree": name, **r})
            print(f"{name:4s}  ops.{args.op} {r['ops_us']:.3f} us/call"
                  f"  execute.dispatch {r['dispatch_us']:.3f} us/call"
                  f"  maps encoded {r['ops_map_encodes']}, "
                  f"{r['dispatch_map_encodes']}", flush=True)
    summary = {}
    for name in ("base", "new"):
        mine = [r for r in runs if r["tree"] == name]
        summary[name] = {
            key: {"median": statistics.median(r[key] for r in mine),
                  "min": min(r[key] for r in mine),
                  "max": max(r[key] for r in mine)}
            for key in KEYS}
    print(json.dumps({"runs": runs, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
