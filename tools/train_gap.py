#!/usr/bin/env python3
"""How far ``chip_smoke.py`` phase 4's training on the kernels lands from
its plain path, on each bf16 ``householder_gemm`` route and each
``reflect_gemm_dx`` route, over seeds.

    python3 tools/train_gap.py [--seeds 0 1 2]

Two parts, on one card:

1. The forward, layer by layer: at phase 4's shapes (smollm-360m's four
   adapted linears, T = TRAIN_B·TRAIN_S rows, n = TRAIN_BLOCKS, bf16,
   seeded inputs), ``ops.householder_gemm`` on the ``wgmma`` route and
   with the SIMT route forced, against ``ref_householder_gemm``: the
   share of outputs not bitwise the plain version's, the relative
   Frobenius norm of the difference, and each one's (the plain version's
   too) relative Frobenius distance from the float64 product.
2. Phase 4's training (ETHER n = TRAIN_BLOCKS, TRAIN_STEPS AdamW steps
   through the port's ``Trainer`` with the phase's settings), with the
   model, adapters and data drawn from each seed: on the plain path, on
   the kernels (``auto``: bf16 forwards and dXr backwards on ``wgmma``),
   on the kernels with the forward's SIMT route forced, and on the
   kernels with the backward's SIMT route forced; each kernel run's
   largest per-step relative loss and gradient-norm difference and the
   relative Frobenius norm of its adapter update's difference, against
   the plain run and against the ``auto`` run.

A SIMT route is forced by replacing ``householder_gemm.route`` (the
forward) or ``reflect_gemm_dx.route`` (the backward) for the run.
Prints a line a measurement, the card's name and power limit, and last a
JSON line.
"""

import argparse
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
from repro_torch.kernels import householder_gemm as hh  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reflect_gemm_dx as kdx  # noqa: E402


@contextmanager
def simt_forced(module=hh):
    """Every call of ``module``'s kernel (``householder_gemm`` by
    default, ``reflect_gemm_dx`` for the backward) on the SIMT route."""
    route = module.route
    module.route = lambda *a: "simt"
    try:
        yield
    finally:
        module.route = route


def frob(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def forward_rows(gen) -> list:
    t, n = cs.TRAIN_B * cs.TRAIN_S, cs.TRAIN_BLOCKS
    rows = []
    for d, f in cs.LINEARS[cs.ARCH]:
        x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(d, f, generator=gen, device="cuda") / d ** .5
             ).bfloat16()
        u = torch.randn(n, d // n, generator=gen, device="cuda")
        uh = u.double() / (u.double().norm(dim=1, keepdim=True) + 1e-8)
        xb = x.double().view(t, n, d // n)
        exact = ((xb - 2 * (xb * uh).sum(-1, keepdim=True) * uh).view(t, d)
                 @ w.double())
        plain = ref.ref_householder_gemm(x, w, u)
        ops.reset_launches()
        got = {"wgmma": ops.householder_gemm(x, w, u)}
        with simt_forced():
            got["simt"] = ops.householder_gemm(x, w, u)
        row = {"d": d, "f": f, "t": t, "n": n, "routes": ops.routes(),
               "plain_vs_exact": frob(plain, exact)}
        for name, y in got.items():
            row[name] = {"differs": (y != plain).float().mean().item(),
                         "vs_plain": frob(y, plain),
                         "vs_exact": frob(y, exact)}
        print(f"{d}x{f} T={t} n={n}: plain vs f64 {row['plain_vs_exact']:.4e}"
              + "".join(f"; {k}: {row[k]['differs'] * 100:.3f}% of outputs "
                        f"not the plain's, vs plain {row[k]['vs_plain']:.4e},"
                        f" vs f64 {row[k]['vs_exact']:.4e}" for k in got),
              flush=True)
        rows.append(row)
    return rows


def train(seed: int, backend: str, tmp: str) -> dict:
    """Phase 4's training from ``seed`` on ``backend``: its log and the
    adapters before and after."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.optim import adamw, cosine
    from repro_torch.runtime.trainer import Trainer

    cfg = get_config(cs.ARCH, "full")
    peft = PEFTConfig(method="ether", n_blocks=cs.TRAIN_BLOCKS,
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


def gap(a: dict, b: dict) -> dict:
    """``a`` against ``b``: as phase 4's agreement."""
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
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "unknown"
    print(f"card: {smi}", flush=True)
    torch.use_deterministic_algorithms(True)
    out = {"card": smi,
           "forward": forward_rows(
               torch.Generator(device="cuda").manual_seed(4)),
           "train": []}
    tmp = tempfile.mkdtemp(prefix="train_gap_")
    try:
        for seed in args.seeds:
            runs = {"plain": train(seed, "torch", tmp),
                    "wgmma": train(seed, "auto", tmp)}
            with simt_forced(hh):
                runs["simt"] = train(seed, "auto", tmp)
            ops.reset_launches()
            with simt_forced(kdx):
                runs["simt_bwd"] = train(seed, "auto", tmp)
            simt_bwd_routes = ops.routes("reflect_gemm_dx")
            row = {"seed": seed,
                   "wgmma_vs_plain": gap(runs["wgmma"], runs["plain"]),
                   "simt_vs_plain": gap(runs["simt"], runs["plain"]),
                   "simt_bwd_vs_plain": gap(runs["simt_bwd"], runs["plain"]),
                   "wgmma_vs_simt": gap(runs["wgmma"], runs["simt"]),
                   "wgmma_vs_simt_bwd": gap(runs["wgmma"],
                                            runs["simt_bwd"]),
                   "simt_bwd_routes": simt_bwd_routes,
                   "losses": {k: [m["loss"] for m in r["log"]]
                              for k, r in runs.items()}}
            print(f"seed {seed}: " + "; ".join(
                f"{k} loss {row[k]['loss']:.3e} grad_norm "
                f"{row[k]['grad_norm']:.3e} update {row[k]['update']:.3e}"
                for k in ("wgmma_vs_plain", "simt_vs_plain",
                          "simt_bwd_vs_plain", "wgmma_vs_simt",
                          "wgmma_vs_simt_bwd"))
                + f"; forced backward's routes {simt_bwd_routes}",
                flush=True)
            out["train"].append(row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
