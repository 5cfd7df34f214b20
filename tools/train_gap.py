#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s training on the kernels lands from its plain
path, on each bf16 route of the forward and of the ``reflect_gemm_dx``
backward, over seeds: phase 4 (ETHER), phase 6 (two-sided ETHER+) or
phase 14 (ETHER, or with ``--method hyperadapt`` HyperAdapt, through a
bank).

    python3 tools/train_gap.py [--phase 4|6|14] [--method ether|hyperadapt]
                               [--seeds 0 1 2]

Two parts, on one card:

1. The forward, layer by layer: at the phase's shapes (smollm-360m's four
   adapted linears, T = TRAIN_B·TRAIN_S rows, n = TRAIN_BLOCKS, bf16,
   seeded inputs; phase 14 a BANK_TENANTS-tenant bank read at
   BANK_TRAIN_IDS), the phase's forward kernel (``householder_gemm``,
   ``etherplus_gemm`` two-sided, ``householder_gemm_batched``,
   ``hyperadapt_gemm_batched``) with each
   route forced (``wgmma``, ``simt``), against its plain
   version: the share of outputs not bitwise the plain version's, the
   relative Frobenius norm of the difference, and each one's (the plain
   version's too) relative Frobenius distance from the float64 product.
2. The phase's training (TRAIN_STEPS AdamW steps: through the port's
   ``Trainer`` for phases 4 and 6, through ``steps.make_bank_train_step``
   for phase 14), with the model, adapters (or bank) and data drawn from
   each seed (seed 0 is the phase's own run): on the plain path, on the
   kernels on the rules' routes (``auto``), on the kernels with each
   forward route the rule did not take forced (``wgmma`` or ``simt``),
   and (ETHER and ETHER+, whose backward
   is ``reflect_gemm_dx``) on the kernels with the backward's SIMT route
   forced; each kernel run's largest per-step relative loss and
   gradient-norm difference and the relative Frobenius norm of its
   adapters' (or bank's) update's difference, against the plain run, and
   the ``wgmma`` run's against the others.

A route is forced by replacing the route rule for the run:
``householder_gemm.route``, ``etherplus_gemm.route``,
``batched.gemm_route`` or ``batched.hyperadapt_route`` (the forward;
HyperAdapt's z and y0 run on the forward kernel, so they follow it),
``reflect_gemm_dx.route`` (the backward, which the ETHER bank's backward
consults too).  Prints a line a
measurement, the card's name and power limit, and last a JSON line.
"""

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from contextlib import contextmanager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]
# before CUDA starts: cuBLAS picks deterministic kernels, as in phase 4
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.transforms import resolve_blocks  # noqa: E402
from repro_torch.kernels import batched as kb  # noqa: E402
from repro_torch.kernels import etherplus_gemm as ep  # noqa: E402
from repro_torch.kernels import householder_gemm as hh  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reflect_gemm_dx as kdx  # noqa: E402

# (phase, method): the forward's module, the name of its route rule and
# the forward op
PHASES = {(4, "ether"): (hh, "route", "householder_gemm"),
          (6, "etherplus"): (ep, "route", "etherplus_gemm"),
          (14, "ether"): (kb, "gemm_route", "householder_gemm_batched"),
          (14, "hyperadapt"): (kb, "hyperadapt_route",
                               "hyperadapt_gemm_batched")}


@contextmanager
def forced(module, name="route", on="simt"):
    """Every call that consults ``module.name`` on route ``on``."""
    rule = getattr(module, name)
    setattr(module, name, lambda *a, **k: on)
    try:
        yield
    finally:
        setattr(module, name, rule)


def frob(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def unit(u):
    return u.double() / (u.double().norm(dim=-1, keepdim=True) + 1e-8)


def blockwise(y, u, v=None):
    """y's blocks updated in float64: I − 2ûûᵀ, or I − ûûᵀ + v̂v̂ᵀ with v
    (u, v: (..., n, db), broadcast over y's leading dims)."""
    n, db = u.shape[-2:]
    yb = y.double().reshape(*y.shape[:-1], n, db)
    uh = unit(u)
    pu = (yb * uh).sum(-1, keepdim=True)
    if v is None:
        return (yb - 2 * pu * uh).reshape(y.shape)
    vh = unit(v)
    return (yb - pu * uh + (yb * vh).sum(-1, keepdim=True) * vh
            ).reshape(y.shape)


def forward_rows(gen, phase, method) -> list:
    t, n = cs.TRAIN_B * cs.TRAIN_S, cs.TRAIN_BLOCKS
    module, name, fwd = PHASES[phase, method]
    rows = []
    for d, f in cs.LINEARS[cs.ARCH]:
        x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(d, f, generator=gen, device="cuda") / d ** .5
             ).bfloat16()
        if phase == 4:
            u = torch.randn(n, d // n, generator=gen, device="cuda")
            exact = blockwise(x, u) @ w.double()
            args, plain_fn, op = (x, w, u), ref.ref_householder_gemm, \
                ops.householder_gemm
        elif phase == 6:
            n_out = resolve_blocks(n, f)
            u1, v1 = (torch.randn(n, d // n, generator=gen, device="cuda")
                      for _ in range(2))
            u2, v2 = (torch.randn(n_out, f // n_out, generator=gen,
                                  device="cuda") for _ in range(2))
            exact = blockwise(blockwise(x, u1, v1) @ w.double(), u2, v2)
            args, plain_fn, op = (x, w, u1, v1, u2, v2), \
                ref.ref_etherplus_gemm, ops.etherplus_gemm
        elif method == "hyperadapt":
            rb = 1 + cs.HA_SPREAD * torch.randn(cs.BANK_TENANTS, d,
                                                generator=gen, device="cuda")
            cb = 1 + cs.HA_SPREAD * torch.randn(cs.BANK_TENANTS, f,
                                                generator=gen, device="cuda")
            ids = torch.tensor(cs.BANK_TRAIN_IDS, dtype=torch.int32,
                               device="cuda")
            xs = x.view(cs.TRAIN_B, cs.TRAIN_S, d)
            exact = ((xs.double() * rb[ids.long()][:, None].double())
                     @ w.double()) * cb[ids.long()][:, None].double()
            args, plain_fn, op = (xs, w, rb, cb, ids), \
                ref.ref_hyperadapt_gemm_batched, ops.hyperadapt_gemm_batched
        else:
            bank = torch.randn(cs.BANK_TENANTS, n, d // n, generator=gen,
                               device="cuda")
            ids = torch.tensor(cs.BANK_TRAIN_IDS, dtype=torch.int32,
                               device="cuda")
            xs = x.view(cs.TRAIN_B, cs.TRAIN_S, d)
            exact = blockwise(xs, bank[ids.long()][:, None]) @ w.double()
            args, plain_fn, op = (xs, w, bank, ids), \
                ref.ref_householder_gemm_batched, ops.householder_gemm_batched
        plain = plain_fn(*args)
        ops.reset_launches()
        got = {}
        for on in ("wgmma", "simt"):
            with forced(module, name, on):
                got[on] = op(*args)
        row = {"d": d, "f": f, "t": t, "n": n,
               "routes": ops.routes(fwd),
               "plain_vs_exact": frob(plain, exact)}
        for key, y in got.items():
            row[key] = {"differs": (y != plain).float().mean().item(),
                        "vs_plain": frob(y, plain),
                        "vs_exact": frob(y, exact)}
        print(f"{fwd} {d}x{f} T={t} n={n}: plain vs f64 "
              f"{row['plain_vs_exact']:.4e}"
              + "".join(f"; {k}: {row[k]['differs'] * 100:.3f}% of outputs "
                        f"not the plain's, vs plain {row[k]['vs_plain']:.4e},"
                        f" vs f64 {row[k]['vs_exact']:.4e}" for k in got)
              + f"; routes {row['routes']}", flush=True)
        rows.append(row)
    return rows


def train(seed: int, backend: str, tmp: str, method: str) -> dict:
    """Phase 4's (``method`` "ether") or phase 6's ("etherplus") training
    from ``seed`` on ``backend``: its log and the adapters before and
    after."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.optim import adamw, cosine
    from repro_torch.runtime.trainer import Trainer

    cfg = get_config(cs.ARCH, "full")
    peft = PEFTConfig(method=method, n_blocks=cs.TRAIN_BLOCKS,
                      rank=cs.METHOD_RANK, alpha=float(cs.METHOD_RANK),
                      targets=peft_targets(cs.ARCH), backend=backend)
    log = os.path.join(tmp, f"{seed}_{len(os.listdir(tmp))}.jsonl")
    t = Trainer(cfg, peft, adamw(cosine(cs.TRAIN_LR, cs.TRAIN_STEPS,
                                        cs.TRAIN_WARMUP)),
                seed=seed, device="cuda", log_path=log)

    def snap():
        return {p: v.detach().clone()
                for p, v in flatten_with_paths(t.state["adapters"])}

    init = snap()
    t.fit(SyntheticLMStream(vocab=cfg.vocab, batch=cs.TRAIN_B,
                            seq_len=cs.TRAIN_S, seed=seed),
          steps=cs.TRAIN_STEPS)
    final = snap()
    t.close()
    with open(log) as fh:
        metrics = [json.loads(line) for line in fh]
    return {"log": metrics, "init": init, "final": final}


def bank_setup(seed: int, method: str) -> dict:
    """Phase 14's model, bank of ``method`` tenants, ids, batches and
    optimizer from ``seed`` (seed 0: the phase's own)."""
    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.peft import AdapterBank, init_adapters
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.models import api
    from repro_torch.optim import adamw, cosine

    cfg = get_config(cs.ARCH, "full")
    peft = PEFTConfig(method=method, n_blocks=cs.TRAIN_BLOCKS,
                      rank=cs.METHOD_RANK, alpha=float(cs.METHOD_RANK),
                      targets=peft_targets(cs.ARCH))
    params = api.init_model(cfg, seed=seed, device="cuda")
    trees = [cs.off_init(torch, init_adapters(
        torch.Generator(device="cuda").manual_seed(100 + t + 10000 * seed),
        params, peft), cs.BANK_MOVES[method], 1000 + t + 10000 * seed)
        for t in range(cs.BANK_TENANTS)]
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=cs.TRAIN_B,
                               seq_len=cs.TRAIN_S, seed=seed)
    return {"cfg": cfg, "peft": peft, "params": params,
            "bank": AdapterBank.stack(trees, params, peft),
            "ids": torch.tensor(cs.BANK_TRAIN_IDS, dtype=torch.int32,
                                device="cuda"),
            "batches": [{k: torch.from_numpy(v).long().cuda()
                         for k, v in stream.batch_at(i).items()}
                        for i in range(cs.TRAIN_STEPS)],
            "opt": adamw(cosine(cs.TRAIN_LR, cs.TRAIN_STEPS,
                                cs.TRAIN_WARMUP))}


def bank_train(setup: dict, backend: str) -> dict:
    """Phase 14's training on ``backend``: its losses and gradient norms
    (a log, as the Trainer's), and the bank before and after."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.launch import steps as st
    s = setup
    step = st.make_bank_train_step(
        s["cfg"], dataclasses.replace(s["peft"], backend=backend), s["opt"],
        s["bank"])
    state = st.make_bank_state(s["params"], s["bank"], s["opt"])
    init = {p: v.detach().clone()
            for p, v in flatten_with_paths(state["bank"])}
    log = []
    for batch in s["batches"]:
        state, m = step(state, batch, s["ids"])
        log.append({"loss": m["loss"].item(),
                    "grad_norm": m["grad_norm"].item()})
    final = {p: v.detach().clone()
             for p, v in flatten_with_paths(state["bank"])}
    return {"log": log, "init": init, "final": final}


def gap(a: dict, b: dict) -> dict:
    """``a`` against ``b``: as the phase's agreement."""
    def rel(key):
        return max(abs(x[key] - y[key]) / abs(y[key])
                   for x, y in zip(a["log"], b["log"]))
    num = sum(((a["final"][p] - a["init"][p]) - (b["final"][p] - b["init"][p]))
              .float().square().sum().item() for p in a["init"])
    den = sum((b["final"][p] - b["init"][p]).float().square().sum().item()
              for p in a["init"])
    return {"loss": rel("loss"), "grad_norm": rel("grad_norm"),
            "update": math.sqrt(num / den)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", type=int, choices=sorted({p for p, _ in PHASES}),
                    default=4)
    ap.add_argument("--method", choices=("ether", "hyperadapt"),
                    help="phase 14's method (default ether)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    method = {4: "ether", 6: "etherplus"}.get(
        args.phase, args.method or "ether")
    if (args.phase, method) not in PHASES:
        ap.error(f"phase {args.phase} does not train {method}")
    module, name, fwd = PHASES[args.phase, method]
    # ETHER's and ETHER+'s backward runs reflect_gemm_dx's routes
    dx_bwd = method in ("ether", "etherplus")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "unknown"
    print(f"card: {smi}; phase {args.phase}, {method}", flush=True)
    torch.use_deterministic_algorithms(True)
    out = {"card": smi, "phase": args.phase, "method": method,
           "forward": forward_rows(
               torch.Generator(device="cuda").manual_seed(4), args.phase,
               method),
           "train": []}
    tmp = tempfile.mkdtemp(prefix="train_gap_")
    try:
        for seed in args.seeds:
            if args.phase == 14:
                setup = bank_setup(seed, method)

                def run(backend):
                    return bank_train(setup, backend)
            else:
                def run(backend):
                    return train(seed, backend, tmp, method)
            # the plain path; the kernels on the rule's routes (``auto``);
            # each forward route the rule did not take, forced
            runs, routes = {"plain": run("torch")}, {}
            ops.reset_launches()
            auto = run("auto")
            routes["auto"] = ops.routes(fwd)
            took = [k.split(".", 1)[1] for k, v in routes["auto"].items()
                    if v]
            for on in ("wgmma", "simt"):
                if took == [on]:
                    runs[on] = auto
                    continue
                ops.reset_launches()
                with forced(module, name, on):
                    runs[on] = run("auto")
                routes[on] = ops.routes(fwd)
            row = {"seed": seed,
                   "wgmma_vs_plain": gap(runs["wgmma"], runs["plain"]),
                   "simt_vs_plain": gap(runs["simt"], runs["plain"]),
                   "wgmma_vs_simt": gap(runs["wgmma"], runs["simt"]),
                   "forward_routes": routes}
            keys = ["wgmma_vs_plain", "simt_vs_plain", "wgmma_vs_simt"]
            simt_bwd_routes = None
            if dx_bwd:
                ops.reset_launches()
                with forced(kdx):
                    runs["simt_bwd"] = run("auto")
                simt_bwd_routes = ops.routes(
                    "householder_gemm_batched_bwd" if args.phase == 14
                    else "reflect_gemm_dx")
                row.update(simt_bwd_vs_plain=gap(runs["simt_bwd"],
                                                 runs["plain"]),
                           wgmma_vs_simt_bwd=gap(runs["wgmma"],
                                                 runs["simt_bwd"]),
                           simt_bwd_routes=simt_bwd_routes)
                keys += ["simt_bwd_vs_plain", "wgmma_vs_simt_bwd"]
            row["losses"] = {k: [m["loss"] for m in r["log"]]
                             for k, r in runs.items()}
            print(f"seed {seed}: " + "; ".join(
                f"{k} loss {row[k]['loss']:.3e} grad_norm "
                f"{row[k]['grad_norm']:.3e} update {row[k]['update']:.3e}"
                for k in keys)
                + f"; forward routes {routes}"
                + (f"; forced backward's routes {simt_bwd_routes}"
                   if dx_bwd else ""), flush=True)
            out["train"].append(row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
