#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phase-2 row groups alone on the card.

    python3 tools/phase2_rows.py [GROUP ...]

GROUP is ``method`` (DeLoRA's and HyperAdapt's single-tenant rows,
``method_kernel_rows``), ``bank`` (the bank forwards, ``bank_kernel_rows``)
or ``bankbwd`` (the bank backwards, ``bank_bwd_rows``); all three by
default.  Each group runs as the script runs it: every kernel through its
wrapper against its plain version (failing as the script fails), timed
with CUDA events beside the plain version and ``torch.matmul``, each
bf16 call's route and each route forced where the group has routes.
Prints the card's name and power limit, each row, then each op's sum over
one smollm-360m layer's seven linears at decode (T = 4; a bank's B = 4,
S = 1) and train size (T = 2,048; B = 16, S = 128) beside
``torch.matmul``'s, and last a JSON line with every row.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import batched as kb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GROUPS = {"method": lambda: cs.method_kernel_rows(torch, ops, ref),
          "bank": lambda: cs.bank_kernel_rows(torch, ops, ref),
          "bankbwd": lambda: cs.bank_bwd_rows(torch, ops, ref, kb)}
# op: (the group it is in, rows at decode, rows at train size, other keys)
SUMS = {"delora_gemm": ("method", cs.B, max(cs.ROWS),
                        {"r": cs.METHOD_RANK}),
        "hyperadapt_gemm": ("method", cs.B, max(cs.ROWS), {}),
        "delora_gemm_batched": ("bank", cs.B, 16 * 128,
                                {"r": cs.METHOD_RANK}),
        "hyperadapt_gemm_batched": ("bank", cs.B, 16 * 128, {})}


def main(argv) -> int:
    groups = argv or list(GROUPS)
    if not torch.cuda.is_available():
        print("phase2_rows: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    rows = []
    for g in groups:
        rows += GROUPS[g]()
    sums = {}
    for op, (group, t_dec, t_train, match) in SUMS.items():
        if group not in groups:
            continue
        for size, t in (("decode", t_dec), ("train", t_train)):
            s = cs.layer_summary(rows, op, None, t, **match)
            sums[f"{op} {size}"] = s
            print(f"{op} {size} (T={t}) layer sum: {s['ms']:.4f} ms, "
                  f"matmul {s['matmul_ms']:.4f} ms, bound "
                  f"{s['bound_ms']:.4f} ms ({s['bound_by']}), plain "
                  f"{s['plain_ms']:.4f} ms", flush=True)
    print(json.dumps({"card": smi, "sums": sums, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
