"""Training CLI of the port — the flags and defaults of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --variant smoke --steps 5

Defaults run the paper's regime: frozen base + ETHER adapters (n_blocks
32), AdamW (no weight decay, clip 1.0), cosine schedule with warmup, lr
2e-3, batch 8 × 128 tokens, checkpoint/auto-resume when ``--ckpt-dir`` is
given.  ``--method`` takes every ported method: ``etherplus``
(two-sided), ``delora`` and ``hyperadapt`` (on their own kernels),
``oft``, ``naive``, ``lora`` and ``full`` (full finetuning of every base
parameter); ``--rank`` sets the LoRA/DeLoRA rank, and alpha = rank as in
the JAX CLI.  Weights are random, made from ``--seed``.  Runs on the card
(``--device cuda``, the default) and raises when there is none;
``--device cpu`` runs the plain versions of the kernels on the CPU.
``--backend`` picks the kernel ops' implementation (torch, cuda, auto).
``--peft-mode`` takes the JAX CLI's three modes: ``activation`` (the
fused GEMM kernels), ``weight`` (``x @ merge(W)``: the merge kernels and,
for ETHER and ETHER+, their backwards ``merge_left_bwd`` and
``merge_right_bwd``) and ``blockgemm`` (the paper's dense block GEMMs,
plain PyTorch).  Not ported yet (NotPortedError): ``--mesh`` and
``--method vera``.
"""

from __future__ import annotations

import argparse

from repro_torch import NotPortedError


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--method", default="ether",
                    help="PEFT method name (repro_torch.core.methods."
                         "available())")
    ap.add_argument("--n-blocks", type=int, default=32)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--peft-mode", default="activation",
                    choices=["activation", "weight", "blockgemm"])
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", default="auto", choices=["auto", "none"])
    ap.add_argument("--mesh", default=None,
                    help="data,model device grid (not ported)")
    ap.add_argument("--log", default=None, help="metrics JSONL path")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="failure injection (fault-tolerance tests)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="auto",
                    choices=["torch", "cuda", "auto"],
                    help="implementation of the kernel ops: torch (plain), "
                         "cuda (kernels) or auto (cuda on the card)")
    return ap


def run(args) -> dict:
    from repro_torch.configs import get_config, peft_targets
    from repro_torch.core.transforms import PEFTConfig
    from repro_torch.data.pipeline import make_stream
    from repro_torch.optim import adamw, constant, cosine, wsd
    from repro_torch.runtime.trainer import Trainer

    if args.mesh:
        raise NotPortedError("--mesh (sharded training)")
    cfg = get_config(args.arch, args.variant)
    peft = PEFTConfig(method=args.method, n_blocks=args.n_blocks,
                      rank=args.rank, alpha=float(args.rank),
                      mode=args.peft_mode, targets=peft_targets(args.arch),
                      backend=args.backend)
    sched = {"cosine": lambda: cosine(args.lr, args.steps, args.warmup),
             "wsd": lambda: wsd(args.lr, args.steps, args.warmup),
             "constant": lambda: constant(args.lr)}[args.schedule]()
    opt = adamw(sched, weight_decay=args.weight_decay)
    stream = make_stream(
        args.data, vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len,
        seed=args.seed, **({"path": args.data_path}
                           if args.data == "binary" else {}))
    trainer = Trainer(cfg, peft, opt, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, restore=args.restore,
                      seed=args.seed, log_path=args.log,
                      fail_at_step=args.fail_at_step, device=args.device)
    try:
        metrics = trainer.fit(stream, steps=args.steps)
    finally:
        trainer.close()
    print(f"done @ step {trainer.step}: {metrics}")
    return metrics


def main(argv=None):
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
