#!/usr/bin/env python3
"""Time a single-tenant and a bank train step of two source trees in
turn, on one card, with the host cost of their forward kernels' calls.

    python3 tools/train_pair.py BASE_SRC NEW_SRC [--rounds R]
                                [--single etherplus|delora]
                                [--bank ether|hyperadapt]

BASE_SRC and NEW_SRC are the ``src`` directories of two checkouts (for
example the parent commit unpacked with ``git archive`` and this tree).
Each run is a process of its own with that tree's ``src`` on
``PYTHONPATH``, in the order base, new, new, base, R times over, so that
a drift of the host or the card during the call falls on both trees
alike.  Each tree builds its kernels into its own ``_build`` on its first
run.  A run takes, with this repo's ``chip_smoke.py`` constants:

- ``chip_smoke.py`` phase 6's training (``--single etherplus``, the
  default; ``delora``: phase 8's): smollm-360m at full width, ETHER+
  two-sided (DeLoRA rank METHOD_RANK), n_blocks TRAIN_BLOCKS, B·S =
  TRAIN_B·TRAIN_S, AdamW, backend ``auto``, TRAIN_STEPS steps through the
  tree's ``Trainer``, deterministic algorithms on; the steady step ms is
  the mean of steps 2 on, as the Trainer logs them (host clock);
- phase 14's: the same model through a bank of BANK_TENANTS ETHER
  (``--bank hyperadapt``: HyperAdapt) tenants, ids BANK_TRAIN_IDS,
  TRAIN_STEPS steps of the tree's ``make_bank_train_step``, each step
  timed on the host to its loss's read-back;
- the host µs a call of the two methods' forward ops
  (``ops.etherplus_gemm`` two-sided or ``ops.delora_gemm``;
  ``ops.householder_gemm_batched`` or ``ops.hyperadapt_gemm_batched``)
  at those steps' shapes: one step's
  224 adapted linears, each weight with its own hyperplanes, each layer's
  seven calls timed from a synchronize to the return of its last call
  (the host's time, not the device's), summed over HOST_ROUNDS passes
  after one pass of warm-up;
- with ``--bank hyperadapt``, where the tree's wgmma route has a
  tensor-map cache (``batched.hyperadapt_map_counts``), the maps encoded
  in each bank step and in the timed host calls.

Prints the card's name and power limit, each run's numbers, and last a
JSON line with every run and each tree's median and range.  Exits
non-zero if a run fails.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_ROUNDS = 5
CHILD = r"""
import json, os, sys, tempfile, time
import torch
sys.path.append(sys.argv[1])
import chip_smoke as cs
from repro_torch.configs import get_config, peft_targets
from repro_torch.core.peft import AdapterBank, init_adapters
from repro_torch.core.transforms import PEFTConfig, resolve_blocks
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.kernels import batched as kb
from repro_torch.kernels import ops
from repro_torch.launch import steps as st
from repro_torch.models import api
from repro_torch.optim import adamw, cosine
from repro_torch.runtime.trainer import Trainer

rounds = int(sys.argv[2])
single, banked = sys.argv[3], sys.argv[4]
cfg = get_config(cs.ARCH, "full")
targets = peft_targets(cs.ARCH)
stream = SyntheticLMStream(vocab=cfg.vocab, batch=cs.TRAIN_B,
                           seq_len=cs.TRAIN_S, seed=0)
torch.use_deterministic_algorithms(True)
out = {}
# the HyperAdapt bank's tensor-map cache, where the tree's wgmma route has
# one: maps encoded in each bank step and in the timed host calls
counts = (getattr(kb, "hyperadapt_map_counts", None)
          if banked == "hyperadapt" else None)

def encodes():
    return counts()["encodes"] if counts else 0

def opt():
    return adamw(cosine(cs.TRAIN_LR, cs.TRAIN_STEPS, cs.TRAIN_WARMUP))

def peft(method):
    return PEFTConfig(method=method, n_blocks=cs.TRAIN_BLOCKS,
                      rank=cs.METHOD_RANK, alpha=float(cs.METHOD_RANK),
                      targets=targets)

def steady(ms):
    return sum(ms[1:]) / (len(ms) - 1)

with tempfile.TemporaryDirectory() as tmp:
    log = os.path.join(tmp, "ep.jsonl")
    tr = Trainer(cfg, peft(single), opt(), seed=0, device="cuda",
                 log_path=log)
    tr.fit(stream, steps=cs.TRAIN_STEPS)
    tr.close()
    with open(log) as fh:
        ms = [json.loads(line)["step_time"] * 1e3 for line in fh]
out["single_step_ms"] = steady(ms)
out["single_steps"] = ms
del tr
torch.cuda.empty_cache()

params = api.init_model(cfg, seed=0, device="cuda")
p = peft(banked)
bank = AdapterBank.stack([init_adapters(
    torch.Generator(device="cuda").manual_seed(100 + t), params, p)
    for t in range(cs.BANK_TENANTS)], params, p)
ids = torch.tensor(cs.BANK_TRAIN_IDS, dtype=torch.int32, device="cuda")
batches = [{k: torch.from_numpy(v).long().cuda()
            for k, v in stream.batch_at(i).items()}
           for i in range(cs.TRAIN_STEPS)]
step = st.make_bank_train_step(cfg, p, opt(), bank)
state = st.make_bank_state(params, bank, opt())
ms, enc = [], []
for b in batches:
    e0 = encodes()
    t0 = time.perf_counter()
    state, m = step(state, b, ids)
    m["loss"].item()
    ms.append((time.perf_counter() - t0) * 1e3)
    enc.append(encodes() - e0 if counts else None)
out["bank_step_ms"] = steady(ms)
out["bank_steps"] = ms
out["bank_step_map_encodes"] = enc
del state, step, bank, params
torch.cuda.empty_cache()

# host µs a call at the train steps' shapes
d, hd = cfg.d_model, cfg.head_dim or cfg.d_model // cfg.n_heads
q, kv, ff = cfg.n_heads * hd, cfg.n_kv * hd, cfg.d_ff
layer = ((0, d, q), (0, d, kv), (0, d, kv), (1, q, d), (2, d, ff),
         (2, d, ff), (3, ff, d))
gen = torch.Generator(device="cuda").manual_seed(3)
n, rows, a_n = cs.TRAIN_BLOCKS, cs.TRAIN_B * cs.TRAIN_S, cs.BANK_TENANTS

def randn(*shape):
    return torch.randn(*shape, generator=gen, device="cuda")

r = cs.METHOD_RANK
makers = {
    "etherplus": ("etherplus_gemm", lambda x, k, f: (
        x.view(rows, k), (randn(k, f) / k ** .5).bfloat16(),
        randn(n, k // n), randn(n, k // n),
        *(randn(resolve_blocks(n, f), f // resolve_blocks(n, f))
          for _ in range(2)))),
    "delora": ("delora_gemm", lambda x, k, f: (
        x.view(rows, k), (randn(k, f) / k ** .5).bfloat16(), randn(k, r),
        randn(r, f), (randn(r).abs() + 0.1).bfloat16())),
    "ether": ("householder_gemm_batched", lambda x, k, f: (
        x, (randn(k, f) / k ** .5).bfloat16(), randn(a_n, n, k // n), ids)),
    "hyperadapt": ("hyperadapt_gemm_batched", lambda x, k, f: (
        x, (randn(k, f) / k ** .5).bfloat16(), 1 + 0.3 * randn(a_n, k),
        1 + 0.3 * randn(a_n, f), ids))}
for key, (name, make) in (("single", makers[single]),
                          ("bank", makers[banked])):
    fn = getattr(ops, name)
    layers = []
    for _ in range(cfg.n_layers):
        xs = [randn(cs.TRAIN_B, cs.TRAIN_S, w).bfloat16()
              for w in (d, q, d, ff)]
        layers.append([make(xs[i], k, f) for i, k, f in layer])
    host_s, calls, e0 = 0.0, 0, None
    for rnd in range(rounds + 1):
        if rnd == 1:
            e0 = encodes()
        for lin in layers:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for call in lin:
                fn(*call)
            if rnd:
                host_s += time.perf_counter() - t0
                calls += len(lin)
    torch.cuda.synchronize()
    out[f"{key}_us"] = host_s / calls * 1e6
    out[f"{key}_op"] = name
    out[f"{key}_map_encodes"] = (encodes() - e0 if counts and key == "bank"
                                 else None)
    del layers
print(json.dumps(out))
"""
KEYS = ("single_step_ms", "bank_step_ms", "single_us", "bank_us")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(src: str, single: str, bank: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    out = subprocess.run(
        [sys.executable, "-c", CHILD, REPO, str(HOST_ROUNDS), single, bank],
        capture_output=True, text=True, env=env, timeout=1800)
    if out.returncode:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"the run in {src} failed (exit {out.returncode})")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--single", default="etherplus",
                    choices=("etherplus", "delora"))
    ap.add_argument("--bank", default="ether", choices=("ether", "hyperadapt"))
    args = ap.parse_args(argv)
    print(f"card: {card()}; {args.single} and a {args.bank} bank",
          flush=True)
    runs = []
    for _ in range(args.rounds):
        for name in ("base", "new", "new", "base"):
            r = run(getattr(args, name), args.single, args.bank)
            runs.append({"tree": name, **r})
            print(f"{name:4s}  " + "  ".join(f"{k} {r[k]:.3f}" for k in KEYS)
                  + f"  maps encoded: bank steps "
                  f"{r['bank_step_map_encodes']}, bank host calls "
                  f"{r['bank_map_encodes']}", flush=True)
    summary = {}
    for name in ("base", "new"):
        mine = [r for r in runs if r["tree"] == name]
        summary[name] = {
            key: {"median": statistics.median(r[key] for r in mine),
                  "min": min(r[key] for r in mine),
                  "max": max(r[key] for r in mine)}
            for key in KEYS}
    print(json.dumps({"card": card(), "runs": runs, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
