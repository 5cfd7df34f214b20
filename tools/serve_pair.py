#!/usr/bin/env python3
"""Time one serving run of two source trees in turn, on one card.

    python3 tools/serve_pair.py BASE_SRC NEW_SRC [--rounds R] [-- SERVE_ARGS]

BASE_SRC and NEW_SRC are the ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this tree).
Each run is ``python -m repro_torch.launch.serve SERVE_ARGS`` in a
process of its own, with that tree's ``src`` alone on ``PYTHONPATH``, in
the order base, new, new, base, R times over, so that a drift of the
host or the card during the call falls on both trees alike.  Each tree
builds its kernels into its own ``_build`` on its first run.  The
default SERVE_ARGS are ``chip_smoke.py`` phase 3's unmerged run
(smollm-360m at full width, ETHER n_blocks 8, B = 4, P = 32, backend
``auto``) with 64 new tokens.  Prints each run's prefill ms and decode
ms per token as the CLI reports them (host clock, after a warm-up
prefill and step), the card's name and power limit, and last a JSON
line with every run's numbers and each tree's median and range of the
decode ms per token.  Exits non-zero if a run fails.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

DEFAULT = ["--arch", "smollm-360m", "--variant", "full", "--batch", "4",
           "--prompt-len", "32", "--n-blocks", "8", "--gen", "64"]
TIMES = re.compile(r"prefill: ([0-9.]+) ms\s+decode: ([0-9.]+) ms/token")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(src: str, serve_args: list) -> tuple:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *serve_args],
        capture_output=True, text=True, env=env, timeout=1800)
    found = TIMES.search(out.stdout)
    if out.returncode or not found:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"serve failed in {src} (exit {out.returncode})")
    return float(found.group(1)), float(found.group(2))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("serve_args", nargs="*")
    args = ap.parse_args(argv)
    serve_args = args.serve_args or DEFAULT
    print(f"card: {card()}", flush=True)
    print(f"serve {' '.join(serve_args)}", flush=True)
    runs = []
    for _ in range(args.rounds):
        for name in ("base", "new", "new", "base"):
            prefill, decode = run(getattr(args, name), serve_args)
            runs.append({"tree": name, "prefill_ms": prefill,
                         "decode_ms_per_token": decode})
            print(f"{name:4s}  prefill {prefill} ms  decode {decode} "
                  f"ms/token", flush=True)
    decode = {name: [r["decode_ms_per_token"] for r in runs
                     if r["tree"] == name] for name in ("base", "new")}
    print(json.dumps({"serve_args": serve_args, "runs": runs,
                      "decode_ms_per_token": {
                          name: {"median": statistics.median(v),
                                 "min": min(v), "max": max(v)}
                          for name, v in decode.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
