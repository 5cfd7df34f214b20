#!/usr/bin/env python3
"""Time each route of ``flash_attention`` at shapes that more than one
route can take, on one card: the kernel's own device time and a call's.

    PYTHONPATH=src python3 tools/flash_routes.py [--out FILE]

At each of SHAPES (bf16, causal, the queries ending at the cache's last
key) every route that takes the shape is forced in turn by replacing
``flash_attention.route``: ``simt`` always, ``wgmma`` at D 64 and 128,
``decode`` where a KV group brings at most ``DECODE_ROWS`` rows.  Each is
held to ``chip_smoke.FLASH_TOL`` against ``ref_flash_attention`` on the
same tensors and timed two ways:

* ``call_ms``: ``chip_smoke.timed_ms``, CUDA events around a loop of
  calls (the host's cost of a call shows where it exceeds the kernel's);
* ``device_ms``: the route's kernels' device time a call in a
  ``torch.profiler`` trace of CALLS calls (``chip_smoke.trace_steps``).

Prints the card's name and power limit, a line a (shape, route), and
last a JSON line with every row and the route ``flash_attention.route``
picks at each shape.  Exits non-zero if a route disagrees with the plain
version.  Writes the JSON line to ``--out`` too.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# (name, B, H, Hkv, S, T, D): smollm-360m's prefill (phases 3-12 serve
# P = 32) and decode, qwen2.5-32b's short prefills, decode and phase 17's
# prefill
SHAPES = tuple(("smollm-360m prefill", 4, 15, 5, s, s, 64)
               for s in (32, 64, 128, 256, 512)) + (
    ("smollm-360m decode", 4, 15, 5, 1, 48, 64),) + tuple(
    ("qwen2.5-32b prefill", 2, 40, 8, s, s, 128)
    for s in (16, 32, 64, 128, 256, 2048)) + (
    ("qwen2.5-32b decode", 2, 40, 8, 1, 2064, 128),)
CALLS = 20


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def routes_of(h, hkv, s, d):
    """The routes that take a bf16 call of this shape."""
    out = ["simt"]
    if d in fa.WGMMA_HEAD_DIMS:
        out.append("wgmma")
    if s * (h // hkv) <= fa.DECODE_ROWS:
        out.append("decode")
    return out


def forced(name):
    """A ``flash_attention.route`` that answers ``name``."""
    return lambda *a: name


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_routes needs a CUDA card")
    print(f"card: {card()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(16)
    chosen = fa.route
    rows = []
    try:
        for name, b, h, hkv, s, t, d in SHAPES:
            q = torch.randn(b, h, s, d, generator=gen,
                            device="cuda").bfloat16()
            k, v = (torch.randn(b, hkv, t, d, generator=gen,
                                device="cuda").bfloat16() for _ in "kv")
            kw = dict(causal=True, window=None, q_offset=t - s)
            want = ref.ref_flash_attention(q, k, v, **kw)
            picked = chosen(torch.bfloat16, d, s * (h // hkv))
            for on in routes_of(h, hkv, s, d):
                fa.route = forced(on)
                ops.reset_launches()
                got = ops.flash_attention(q, k, v, **kw)
                took = {r for r, n in ops.routes("flash_attention").items()
                        if n}
                if took != {f"flash_attention.{on}"}:
                    raise SystemExit(f"{name} S={s}: forced {on}, took "
                                     f"{took}")
                err = chip_smoke.frob(got.float(), want.float())
                if not err <= chip_smoke.FLASH_TOL["bfloat16"]:
                    raise SystemExit(f"{name} S={s} {on}: error {err:.3e}")

                def calls():
                    for _ in range(CALLS):
                        ops.flash_attention(q, k, v, **kw)
                    torch.cuda.synchronize()

                call_ms = chip_smoke.timed_ms(
                    torch, [lambda: ops.flash_attention(q, k, v, **kw)])
                trace = chip_smoke.trace_steps(torch, calls, CALLS)
                rows.append(dict(shape=name, b=b, h=h, hkv=hkv, s=s, t=t,
                                 d=d, route=on, picked=picked,
                                 rel_err=err, call_ms=call_ms,
                                 device_ms=trace["flash_ms"]))
                print("{shape:20s} B={b} H={h}/{hkv} S={s} T={t} D={d}  "
                      "{route:6s}{mark}  err {rel_err:.2e}  call "
                      "{call_ms:.4f} ms  device {device_ms:.4f} ms".format(
                          mark=" *" if on == picked else "  ", **rows[-1]),
                      flush=True)
            del q, k, v, want, got
    finally:
        fa.route = chosen
    line = json.dumps({"card": card(), "calls": CALLS,
                       "rows": rows})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
