#!/usr/bin/env python3
"""Time the two epilogues of two-sided ``etherplus_gemm``'s ``wgmma``
route against each other, on one card, over the row counts of the port's
paths.

    PYTHONPATH=src python3 tools/ep_epilogues.py [--rows 4,128,1024,2048]

At smollm-360m's four linear shapes (``chip_smoke.LINEARS``), n 8 and 32
(``chip_smoke.BLOCKS``), bf16, each epilogue is forced on the launcher
(``etherplus_gemm.launch(..., on="wgmma", epi=...)``): ``fused`` (H̃⁺ on
the accumulators of column tiles of ``tile_blocks`` whole output blocks)
wherever such a tile holds one block, and ``scratch`` (y0 in f32 to device
memory, then ``rank2_rows_kernel``).  Each is held to the plain version
(``chip_smoke.TOL``) and timed with ``chip_smoke.timed_ms`` (CUDA events
around a loop of calls, each on its own copy of W).  Prints the card's
name and power limit, a line a shape with the epilogue
``etherplus_gemm.epilogue`` picks, each one-layer sum (the seven linears,
``chip_smoke.LAYER``) by epilogue and picked, and last a JSON line with
every row.  Exits non-zero if an epilogue disagrees with the plain
version.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from repro_torch.core.transforms import resolve_blocks  # noqa: E402
from repro_torch.kernels import etherplus_gemm as kep  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="4,128,1024,2048")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rows = []
    for d, f in cs.LINEARS["smollm-360m"]:
        w0 = (randn(d, f) / d ** .5).bfloat16()
        ws = [w0.clone() for _ in range(max(1, min(256, int(
            100e6 // (d * f * 2)) + 1)))]
        for n in cs.BLOCKS:
            n_out = resolve_blocks(n, f)
            u1, v1 = randn(n, d // n), randn(n, d // n)
            u2, v2 = randn(n_out, f // n_out), randn(n_out, f // n_out)
            for t in map(int, args.rows.split(",")):
                x = randn(t, d).bfloat16()
                want = ref.ref_etherplus_gemm(x, ws[0], u1, v1, u2, v2)
                row = dict(d=d, f=f, n=n, db_out=f // n_out, t=t,
                           picked=kep.epilogue(n_out, f // n_out))
                for epi in ("fused", "scratch"):
                    if epi == "fused" and not kep.tile_blocks(n_out,
                                                              f // n_out):
                        continue
                    err, y, _ = kep.launch(x, ws[0], u1, v1, u2, v2,
                                           on="wgmma", epi=epi)
                    rel = ((y.float() - want.float()).abs().max()
                           / want.float().abs().max()).item()
                    if err or rel > cs.TOL["bfloat16"]:
                        raise SystemExit(f"{epi} at {row}: error {err}, "
                                         f"rel {rel:.3e}")
                    row[f"{epi}_ms"] = cs.timed_ms(torch, [
                        lambda w=w, epi=epi: kep.launch(
                            x, w, u1, v1, u2, v2, on="wgmma", epi=epi)
                        for w in ws])
                rows.append(row)
                print("d={d:5d} f={f:5d} n={n:2d} db_out={db_out:3d} "
                      "T={t:5d} picks {picked:7s}".format(**row)
                      + "".join(f"  {k} {row[k]:.4f}" for k in
                                ("fused_ms", "scratch_ms") if k in row),
                      flush=True)
    sums = {}
    for n in cs.BLOCKS:
        for t in map(int, args.rows.split(",")):
            mine = [r for r in rows if r["n"] == n and r["t"] == t]
            s = {k: sum(cs.LAYER[(r["d"], r["f"])] * r.get(
                k, r["scratch_ms"]) for r in mine)
                for k in ("fused_ms", "scratch_ms")}
            s["picked_ms"] = sum(cs.LAYER[(r["d"], r["f"])] * r[
                f"{r['picked']}_ms"] for r in mine)
            sums[f"n={n} T={t}"] = s
            print(f"layer n={n} T={t}: fused where a tile holds a block "
                  f"{s['fused_ms']:.4f} ms, scratch {s['scratch_ms']:.4f}, "
                  f"as picked {s['picked_ms']:.4f}", flush=True)
    print(json.dumps({"card": card, "rows": rows, "layer_sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
