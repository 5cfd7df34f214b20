#!/usr/bin/env python3
"""Compare the phase-2 kernel rows of two ``chip_smoke.py`` runs.

    python3 tools/compare_chip_smoke.py BASE.json NEW.json [--changed K ...]

BASE and NEW are the ``chiprun_out/chip_smoke.json`` of two runs, for
example the parent commit and a change run one after the other in one
call on one card.  Rows are matched on their shape keys (kernel, arch,
dtype, T, d, f, n, rank, two_sided, and r, the DeLoRA rank); for each
kernel (the backward compositions ``delora_gemm_bwd`` and
``hyperadapt_gemm_bwd`` each count as one) it prints how many rows
matched, whether every matched row's error against the plain version is
bitwise the same in both runs, and the new/base ratio of the kernel's
time (median, min, max).  A kernel in only one of the runs is listed as
such.  Exits non-zero if a kernel's errors differ, unless the kernel is
named after ``--changed`` (one the change redesigned, whose errors are
expected to move): its rows are then printed one by one, with each
row's base and new ms and the speed-up base/new.
"""

import json
import statistics
import sys

KEYS = ("kernel", "arch", "dtype", "t", "d", "f", "n", "rank", "two_sided",
        "r")


def key(row):
    """The row's shape keys; a reflect-GEMM row of a run older than the
    ETHER+ kernels carries no rank, and is rank 1."""
    rank = row.get("rank", 1 if row["kernel"].startswith("reflect_gemm")
                   else None)
    return tuple(rank if k == "rank" else row.get(k) for k in KEYS)


def rows(path):
    with open(path) as fh:
        return {key(r): r for r in json.load(fh)["rows"]}


def main(argv):
    changed = set()
    if "--changed" in argv:
        at = argv.index("--changed")
        argv, changed = argv[:at], set(argv[at + 1:])
    base, new = rows(argv[0]), rows(argv[1])
    by_kernel = {}
    for key in sorted(base.keys() & new.keys(), key=str):
        by_kernel.setdefault(key[0], []).append((base[key], new[key]))
    differ = False
    for kernel, pairs in by_kernel.items():
        same = all(a["max_abs_err"] == b["max_abs_err"]
                   and a["rel_err"] == b["rel_err"] for a, b in pairs)
        differ |= not same and kernel not in changed
        ratio = [b["ms"] / a["ms"] for a, b in pairs]
        print(f"{kernel:22s} {len(pairs):3d} rows  errors "
              f"{'bitwise equal' if same else 'DIFFER'}  time new/base "
              f"median {statistics.median(ratio):.3f} (min {min(ratio):.3f}, "
              f"max {max(ratio):.3f})")
        if kernel in changed:
            for a, b in pairs:
                print(f"    {b.get('arch')!s:22s} {b['dtype']:8s} "
                      f"{b.get('route', '')!s:7s} base {a['ms']:.4f} ms  "
                      f"new {b['ms']:.4f} ms  x{a['ms'] / b['ms']:.2f}  "
                      f"err {a['rel_err']:.2e} -> {b['rel_err']:.2e}")
    for name, run in (("base", base), ("new", new)):
        only = sorted({k[0] for k in run} - set(by_kernel))
        if only:
            print(f"only in {name}: {', '.join(only)}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
