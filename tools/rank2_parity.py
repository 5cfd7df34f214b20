#!/usr/bin/env python3
"""Rows 7 and 25 (``etherplus_reflect_batched`` and its backward) of two
source trees, bit for bit, on one card.

    python3 tools/rank2_parity.py BASE_SRC NEW_SRC

BASE_SRC and NEW_SRC are the ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this tree).
Each tree runs in a process of its own, with that tree's ``src`` on
``PYTHONPATH``, the ops through its ``ops`` wrappers on the same seeded
operands: smollm-360m's four linear shapes on both sides (x over d, its
product with W over f), bf16 and f32, a BANK_TENANTS-tenant bank read at
BANK_TRAIN_IDS, at decode (B sequences of S = 1, n = N_BLOCKS), the bank
prefill (16 × 128, n = N_BLOCKS) and phase 14's train shape (TRAIN_B ×
TRAIN_S, n = TRAIN_BLOCKS).  Prints the card's name and power limit and,
for every output (out; dx, du, dv), whether the trees agree bit for bit,
the share of elements that differ and the largest difference relative to
the largest value; last a JSON line.  Exits 1 if an output differs.
"""

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r"""
import sys
import torch
sys.path.append(sys.argv[1])
import chip_smoke as cs
from repro_torch.core.transforms import resolve_blocks
from repro_torch.kernels import ops
gen = torch.Generator(device="cuda").manual_seed(11)
a_n, out = cs.BANK_TENANTS, {}
for size, nb, ns, n in (("decode", cs.B, 1, cs.N_BLOCKS),
                        ("prefill", 16, 128, cs.N_BLOCKS),
                        ("train", cs.TRAIN_B, cs.TRAIN_S, cs.TRAIN_BLOCKS)):
    ids = torch.tensor((cs.BANK_TRAIN_IDS * nb)[:nb], dtype=torch.int32,
                       device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        for d, f in cs.LINEARS[cs.ARCH]:
            def randn(*shape):
                return torch.randn(*shape, generator=gen, device="cuda")
            w = (randn(d, f) / d ** .5).to(dt)
            x = randn(nb, ns, d).to(dt)
            for side, y, k in (("in", x, d), ("out", x @ w, f)):
                nk = resolve_blocks(n, k)
                u, v = randn(a_n, nk, k // nk), randn(a_n, nk, k // nk)
                g = randn(nb, ns, k).to(dt)
                key = f"{size} {str(dt)[6:]} {d}x{f} {side}"
                out[f"{key} out"] = ops.etherplus_reflect_batched(y, u, v, ids)
                dx, du, dv = ops.etherplus_reflect_batched_bwd(y, u, v, ids,
                                                               g)
                out.update({f"{key} dx": dx, f"{key} du": du,
                            f"{key} dv": dv})
torch.save({k: t.cpu() for k, t in out.items()}, sys.argv[2])
"""


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(src: str, path: str) -> None:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    done = subprocess.run([sys.executable, "-c", CHILD, REPO, path],
                          capture_output=True, text=True, env=env,
                          timeout=900)
    if done.returncode:
        sys.stderr.write(done.stdout[-4000:] + done.stderr[-4000:])
        raise SystemExit(f"the run in {src} failed (exit {done.returncode})")


def main(argv) -> int:
    import torch
    if len(argv) != 2:
        raise SystemExit(__doc__)
    print(f"card: {card()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{i}.pt") for i in range(2)]
        for src, path in zip(argv, paths):
            run(src, path)
        base, new = (torch.load(p) for p in paths)
    rows = []
    for key, a in base.items():
        b = new[key]
        diff = (a.float() - b.float()).abs()
        rows.append({"output": key, "bitwise": bool(torch.equal(a, b)),
                     "differs": (diff > 0).float().mean().item(),
                     "rel_max": (diff.max() / a.float().abs().max()
                                 ).item()})
        r = rows[-1]
        print(f"{key:40s} {'bitwise' if r['bitwise'] else 'DIFFERS'}"
              f"  {r['differs'] * 100:.4f}% of elements, max "
              f"{r['rel_max']:.3e}", flush=True)
    print(json.dumps({"card": card(), "rows": rows}))
    return 0 if all(r["bitwise"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
