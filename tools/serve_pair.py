#!/usr/bin/env python3
"""Time one serving run of two source trees in turn, on one card.

    python3 tools/serve_pair.py BASE_SRC NEW_SRC [--rounds R] [--layers N]
        [-- SERVE_ARGS]

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
decode ms per token.  ``--layers N`` cuts the model's depth to its first
N layers (as ``chip_smoke.py`` phase 17 serves qwen2.5-32b at 8 of its
64), by running each tree's CLI with that tree's ``get_config`` wrapped;
for example phase 17's serve, unmerged, with 32 new tokens:

    python3 tools/serve_pair.py BASE_SRC NEW_SRC --rounds 3 --layers 8 -- \\
        --arch qwen2.5-32b --variant full --batch 2 --prompt-len 2048 \\
        --n-blocks 8 --gen 32

Exits non-zero if a run fails.
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
# the CLI of the tree on PYTHONPATH, its configs cut to argv[1] layers
CUT = r"""
import dataclasses, sys
from repro_torch.launch import serve
get = serve.get_config
serve.get_config = lambda *a: dataclasses.replace(
    get(*a), n_layers=min(int(sys.argv[1]), get(*a).n_layers))
serve.main(sys.argv[2:])
"""
TIMES = re.compile(r"prefill: ([0-9.]+) ms\s+decode: ([0-9.]+) ms/token")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(src: str, serve_args: list, layers=None) -> tuple:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    cmd = (["-m", "repro_torch.launch.serve"] if layers is None
           else ["-c", CUT, str(layers)])
    out = subprocess.run(
        [sys.executable, *cmd, *serve_args],
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
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the model's first LAYERS layers only")
    # SERVE_ARGS after "--", split off here: argparse before Python 3.12.7
    # refuses them once an option has followed the positionals
    cut = argv.index("--") if "--" in argv else len(argv)
    args = ap.parse_args(argv[:cut])
    serve_args = argv[cut + 1:] or DEFAULT
    print(f"card: {card()}", flush=True)
    print(f"serve {' '.join(serve_args)}"
          + ("" if args.layers is None else f" (first {args.layers} layers)"),
          flush=True)
    runs = []
    for _ in range(args.rounds):
        for name in ("base", "new", "new", "base"):
            prefill, decode = run(getattr(args, name), serve_args,
                                  args.layers)
            runs.append({"tree": name, "prefill_ms": prefill,
                         "decode_ms_per_token": decode})
            print(f"{name:4s}  prefill {prefill} ms  decode {decode} "
                  f"ms/token", flush=True)
    decode = {name: [r["decode_ms_per_token"] for r in runs
                     if r["tree"] == name] for name in ("base", "new")}
    print(json.dumps({"serve_args": serve_args, "layers": args.layers,
                      "runs": runs,
                      "decode_ms_per_token": {
                          name: {"median": statistics.median(v),
                                 "min": min(v), "max": max(v)}
                          for name, v in decode.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
