#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s training on the kernels lands from its plain
path, on each bf16 route of the forward and of the ``reflect_gemm_dx``
backward, over seeds: phase 4 (ETHER), phase 6 (two-sided ETHER+), phase
10 (HyperAdapt) or phase 14 (ETHER, or with ``--method hyperadapt``,
``delora`` or ``etherplus`` HyperAdapt, DeLoRA or ETHER+, through a
bank).

    python3 tools/train_gap.py [--phase 4|6|10|14]
                               [--method ether|hyperadapt|delora|etherplus]
                               [--seeds 0 1 2] [--witnesses] [--src DIR]

``--src`` runs the port of another checkout (its ``src`` directory, for
example the parent commit unpacked with ``git archive``) under this
checkout's ``chip_smoke.py`` constants.

Two parts, on one card:

1. The forward, layer by layer: at the phase's shapes (smollm-360m's four
   adapted linears, T = TRAIN_B·TRAIN_S rows, n = TRAIN_BLOCKS, bf16,
   seeded inputs; phase 14 a BANK_TENANTS-tenant bank read at
   BANK_TRAIN_IDS), the phase's forward kernel (``householder_gemm``,
   ``etherplus_gemm`` two-sided, ``hyperadapt_gemm``,
   ``householder_gemm_batched``, ``hyperadapt_gemm_batched``,
   ``delora_gemm_batched`` at rank METHOD_RANK; for the ETHER+ bank
   both sides of a linear through ``etherplus_reflect_batched``, which
   has one route) with each
   route forced (``wgmma``, ``simt``), against its plain
   version: the share of outputs not bitwise the plain version's, the
   relative Frobenius norm of the difference, and each one's (the plain
   version's too) relative Frobenius distance from the float64 product.
2. The phase's training (TRAIN_STEPS AdamW steps: through the port's
   ``Trainer`` for phases 4, 6 and 10, through ``steps.make_bank_train_step``
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

With ``--witnesses`` (phase 14 DeLoRA) two more plain runs a seed, and
each run's gap from them: ``plain_f32``, the plain path in float32 (the
same weights, widened exactly, and the same bank and data), a training
nearer the exact one than any bf16 run; and ``plain_h64``, the plain path
with each h = x·a_t (and dx's g·b_tᵀ) summed in float64 and rounded once
to float32, as the ``wgmma`` route sums it.

A route is forced by replacing the route rule for the run:
``householder_gemm.route``, ``etherplus_gemm.route``,
``hyperadapt_gemm.route``, ``batched.gemm_route``,
``batched.hyperadapt_route`` or ``batched.delora_route`` (the forward;
HyperAdapt's z and y0 and DeLoRA's dx run on the forward kernel, so they
follow it),
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
# the port under test: this checkout's, or --src's
SRC = (sys.argv[sys.argv.index("--src") + 1] if "--src" in sys.argv
       else os.path.join(REPO, "src"))
sys.path[:0] = [os.path.abspath(SRC), REPO]
# before CUDA starts: cuBLAS picks deterministic kernels, as in phase 4
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.transforms import resolve_blocks  # noqa: E402
from repro_torch.kernels import batched as kb  # noqa: E402
from repro_torch.kernels import etherplus_gemm as ep  # noqa: E402
from repro_torch.kernels import householder_gemm as hh  # noqa: E402
from repro_torch.kernels import hyperadapt_gemm as kh  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reflect_gemm_dx as kdx  # noqa: E402

# (phase, method): the forward's module, the name of its route rule and
# the forward op (no rule: the op has one route)
PHASES = {(4, "ether"): (hh, "route", "householder_gemm"),
          (6, "etherplus"): (ep, "route", "etherplus_gemm"),
          (10, "hyperadapt"): (kh, "route", "hyperadapt_gemm"),
          (14, "ether"): (kb, "gemm_route", "householder_gemm_batched"),
          (14, "hyperadapt"): (kb, "hyperadapt_route",
                               "hyperadapt_gemm_batched"),
          (14, "delora"): (kb, "delora_route", "delora_gemm_batched"),
          (14, "etherplus"): (None, None, "etherplus_reflect_batched")}


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
        elif phase == 10:
            r = 1 + cs.HA_SPREAD * torch.randn(d, generator=gen,
                                               device="cuda")
            c = 1 + cs.HA_SPREAD * torch.randn(f, generator=gen,
                                               device="cuda")
            exact = ((x.double() * r.double()) @ w.double()) * c.double()
            args, plain_fn, op = (x, w, r, c), ref.ref_hyperadapt_gemm, \
                ops.hyperadapt_gemm
        elif method == "delora":
            rk, a_n = cs.METHOD_RANK, cs.BANK_TENANTS
            ab = torch.randn(a_n, d, rk, generator=gen, device="cuda")
            bb = torch.randn(a_n, rk, f, generator=gen, device="cuda")
            # the method's scale, (λ/r)/(‖a_j‖‖b_j‖), in the activations'
            # dtype
            sb = ((cs.DELORA_LAM / rk) / (ab.norm(dim=1) * bb.norm(dim=2))
                  ).bfloat16()
            ids = torch.tensor(cs.BANK_TRAIN_IDS, dtype=torch.int32,
                               device="cuda")
            xs = x.view(cs.TRAIN_B, cs.TRAIN_S, d)
            sel = ids.long()
            exact = xs.double() @ w.double() + (
                (xs.double() @ ab[sel].double())
                * sb[sel][:, None].double()) @ bb[sel].double()
            args, plain_fn, op = (xs, w, ab, bb, sb, ids), \
                ref.ref_delora_gemm_batched, ops.delora_gemm_batched
        elif method == "etherplus":
            n_out = resolve_blocks(n, f)
            ub, vb = (torch.randn(cs.BANK_TENANTS, n, d // n, generator=gen,
                                  device="cuda") for _ in range(2))
            u2b, v2b = (torch.randn(cs.BANK_TENANTS, n_out, f // n_out,
                                    generator=gen, device="cuda")
                        for _ in range(2))
            ids = torch.tensor(cs.BANK_TRAIN_IDS, dtype=torch.int32,
                               device="cuda")
            xs = x.view(cs.TRAIN_B, cs.TRAIN_S, d)
            sel = ids.long()
            exact = blockwise(
                blockwise(xs, ub[sel][:, None], vb[sel][:, None])
                @ w.double(), u2b[sel][:, None], v2b[sel][:, None])

            def plain_fn(xs, w, ub, vb, u2b, v2b, ids):
                return ref.ref_etherplus_reflect_batched(
                    ref.ref_etherplus_reflect_batched(xs, ub, vb, ids) @ w,
                    u2b, v2b, ids)

            def op(xs, w, ub, vb, u2b, v2b, ids):
                return ops.etherplus_reflect_batched(
                    ops.etherplus_reflect_batched(xs, ub, vb, ids) @ w,
                    u2b, v2b, ids)
            args = (xs, w, ub, vb, u2b, v2b, ids)
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
        for on in ("wgmma", "simt") if module else ():
            with forced(module, name, on):
                got[on] = op(*args)
        if module is None:
            got["kernels"] = op(*args)
        row = {"d": d, "f": f, "t": t, "n": n,
               "routes": ops.routes(fwd) if module else ops.launches()[fwd],
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
    """Phase 4's (``method`` "ether"), phase 6's ("etherplus") or phase
    10's ("hyperadapt") training from ``seed`` on ``backend``: its log and
    the adapters before and after."""
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


def widened(setup: dict) -> dict:
    """``setup`` in float32: its config's dtypes and its weights widened
    (exactly); the bank (float32 already), ids, data and optimizer as
    they are."""
    cfg = dataclasses.replace(setup["cfg"], param_dtype="float32",
                              compute_dtype="float32")

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(widen(v) for v in tree)
        return tree.float() if tree.is_floating_point() else tree
    return {**setup, "cfg": cfg, "params": widen(setup["params"])}


@contextmanager
def plain_h64():
    """The plain path's DeLoRA bank forward (and, through it, its
    backward's dx) with h summed in float64 and rounded once to float32,
    then scaled by s in float32: the ``wgmma`` route's prologue."""
    from repro_torch.core import execute

    def h64(x, w, a_bank, b_bank, s_bank, ids):
        h = torch.einsum("bsd,bdr->bsr", x.double(),
                         ref.gather(a_bank, ids).double()).float()
        h = h * ref.gather(s_bank, ids).float()[:, None, :]
        return (x.float() @ w.float() + torch.einsum(
            "bsr,brf->bsf", h, ref.gather(b_bank, ids).float())).to(x.dtype)
    key = ("delora_gemm_batched", "torch")
    was = execute._REGISTRY[key], ref.ref_delora_gemm_batched
    execute._REGISTRY[key] = ref.ref_delora_gemm_batched = h64
    try:
        yield
    finally:
        execute._REGISTRY[key], ref.ref_delora_gemm_batched = was


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
    ap.add_argument("--method",
                    choices=("ether", "hyperadapt", "delora", "etherplus"),
                    help="phase 14's method (default ether)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="the src directory of the port to run (read "
                         "before the imports, above)")
    ap.add_argument("--witnesses", action="store_true",
                    help="phase 14 DeLoRA: also the plain path in float32 "
                         "and with h summed in float64")
    args = ap.parse_args(argv)
    method = {4: "ether", 6: "etherplus", 10: "hyperadapt"}.get(
        args.phase, args.method or "ether")
    if (args.phase, method) not in PHASES:
        ap.error(f"phase {args.phase} does not train {method}")
    if args.witnesses and (args.phase, method) != (14, "delora"):
        ap.error("--witnesses is phase 14 DeLoRA's")
    module, name, fwd = PHASES[args.phase, method]
    # ETHER's and ETHER+'s backward runs reflect_gemm_dx's routes (not
    # the ETHER+ bank's, whose backward is etherplus_reflect_batched_bwd)
    dx_bwd = method == "ether" or (args.phase, method) == (6, "etherplus")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "unknown"
    print(f"card: {smi}; phase {args.phase}, {method}; port {SRC}",
          flush=True)
    torch.use_deterministic_algorithms(True)
    out = {"card": smi, "phase": args.phase, "method": method, "src": SRC,
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
            if module is None:      # one route: the kernels against plain
                row = {"seed": seed, "launches": ops.launches()[fwd],
                       "kernels_vs_plain": gap(auto, runs["plain"]),
                       "losses": {"plain": [m["loss"] for m in
                                            runs["plain"]["log"]],
                                  "kernels": [m["loss"] for m in
                                              auto["log"]]}}
                g = row["kernels_vs_plain"]
                print(f"seed {seed}: kernels_vs_plain loss {g['loss']:.3e} "
                      f"grad_norm {g['grad_norm']:.3e} update "
                      f"{g['update']:.3e}; {fwd} launches {row['launches']}",
                      flush=True)
                out["train"].append(row)
                continue
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
            if args.witnesses:
                runs["plain_f32"] = bank_train(widened(setup), "torch")
                with plain_h64():
                    runs["plain_h64"] = run("torch")
                for k in ("plain", "wgmma", "simt", "plain_h64"):
                    row[f"{k}_vs_plain_f32"] = gap(runs[k], runs["plain_f32"])
                    keys.append(f"{k}_vs_plain_f32")
                for k in ("wgmma", "simt", "plain"):
                    row[f"{k}_vs_plain_h64"] = gap(runs[k], runs["plain_h64"])
                    keys.append(f"{k}_vs_plain_h64")
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
