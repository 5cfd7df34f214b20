"""Serving CLI of the port — the one-shot mode of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --variant full --batch 4 --prompt-len 32 --gen 16

* default: unmerged ETHER adapters — every adapted linear reflects its
  activations inside the ``householder_gemm`` kernel;
* ``--merged``: the adapters are first absorbed into the weights with the
  ``ether_merge`` kernel (the paper's zero-latency deployment, §3.1) and
  the plain model is served;
* ``--method etherplus``: ETHER+ adapters (two-sided), through the
  ``etherplus_gemm`` kernel unmerged and the ``etherplus_merge`` kernels
  with ``--merged``;
* ``--method delora`` / ``hyperadapt`` (rank ``--rank`` for DeLoRA):
  through the ``delora_gemm`` / ``hyperadapt_gemm`` kernels unmerged and
  the ``delora_merge`` / ``hyperadapt_merge`` kernels with ``--merged``;
* ``--method oft``, ``naive``, ``lora`` (``--rank``) and ``full``: plain
  PyTorch, as the JAX package runs them in jnp (``full`` serves the base
  model).  ``vera`` raises NotPortedError.

Weights, adapters and prompts are random, made from ``--seed``.  Runs on
the card (``--device cuda``, the default) and raises when there is none;
``--device cpu`` runs the plain versions on the CPU.  Prints prefill ms,
decode ms per token, the dispatch counters and kernel launches, and the
generated tokens.  ``--tenants`` and ``--trace`` are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute
from repro_torch.core.peft import init_adapters, merge_params
from repro_torch.core.transforms import PEFTConfig
from repro_torch.kernels import ops
from repro_torch.models.api import (decode_step, init_model, pad_cache,
                                    prefill, resolve_device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(dim=-1, keepdim=True)         # (B, 1)


def generate(params, adapters, tokens, cfg, peft, gen: int) -> dict:
    """Prefill + ``gen`` greedy decode steps, after one untimed warm-up
    prefill and step.  Returns prefill seconds, seconds per decoded
    token, the generated tokens (B, gen+1), the timed prefill's logits
    (B, 1, V) and the number of backbone forwards run."""
    device = tokens.device
    max_len = tokens.shape[1] + gen + 1

    def pf():
        cache, logits = prefill(params, adapters, {"tokens": tokens}, cfg,
                                peft)
        return pad_cache(cache, cfg, max_len), logits

    cache, logits = pf()
    decode_step(params, adapters, cache, _greedy(logits), cfg, peft)
    _sync(device)

    t0 = time.perf_counter()
    cache, logits = pf()
    tok = _greedy(logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen):
        step_logits, cache = decode_step(params, adapters, cache, tok, cfg,
                                         peft)
        tok = _greedy(step_logits)
        out.append(tok)
    _sync(device)
    t_gen = time.perf_counter() - t0
    return {"prefill_s": t_prefill, "per_token_s": t_gen / max(gen, 1),
            "tokens": torch.cat(out, dim=1).cpu(), "logits": logits,
            "forwards": 3 + gen}


def build(*, arch: str = "smollm-360m", variant: str = "smoke",
          method: str = "ether", n_blocks: int = 8, rank: int = 8,
          batch: int = 4,
          prompt_len: int = 32, merged: bool = False, backend: str = "auto",
          seed: int = 0, device="cuda") -> dict:
    """The model, adapters and prompts of one serving run, made from
    ``seed``: a dict of ``cfg``, ``peft``, ``params``, ``adapters``,
    ``tokens`` and ``merge_s``.  With ``merged`` the adapters are
    absorbed into ``params`` (``adapters`` and ``peft`` are then None)
    and ``merge_s`` is the seconds that took, else None."""
    dev = resolve_device(device)
    cfg = get_config(arch, variant)
    peft = PEFTConfig(method=method, n_blocks=n_blocks, rank=rank,
                      alpha=float(rank), targets=peft_targets(arch),
                      backend=backend)
    params = init_model(cfg, seed=seed, device=dev)
    adapters = init_adapters(
        torch.Generator(device=dev).manual_seed(seed + 1), params, peft)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed + 2), device=dev)
    merge_s = None
    if merged:
        t0 = time.perf_counter()
        params = merge_params(params, adapters, peft)
        _sync(dev)
        merge_s = time.perf_counter() - t0
        adapters, peft = None, None
    return {"cfg": cfg, "peft": peft, "params": params,
            "adapters": adapters, "tokens": tokens, "merge_s": merge_s}


def serve(*, gen: int = 16, **kw) -> dict:
    """Build the model from ``seed`` (keywords of :func:`build`) and
    serve one batch; returns the measurements of :func:`generate` plus
    ``merge_s`` (merged only)."""
    m = build(**kw)
    res = generate(m["params"], m["adapters"], m["tokens"], m["cfg"],
                   m["peft"], gen)
    res["merge_s"] = m["merge_s"]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--variant", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--method", default="ether",
                    help="PEFT method name (repro_torch.core.methods."
                         "available())")
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--rank", type=int, default=8,
                    help="LoRA / DeLoRA rank (alpha = rank)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--merged", action="store_true")
    ap.add_argument("--backend", default="auto",
                    choices=execute.BACKENDS,
                    help="implementation of the kernel ops: torch (plain), "
                         "cuda (kernels) or auto (cuda on the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tenants", type=int, default=0)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    if args.tenants or args.trace:
        raise SystemExit("--tenants and --trace (multi-tenant bank serving "
                         "and the serve engine) are not yet ported, see "
                         "ROADMAP.md")

    execute.reset_counters()
    ops.reset_launches()
    res = serve(arch=args.arch, variant=args.variant, method=args.method,
                n_blocks=args.n_blocks, rank=args.rank, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen,
                merged=args.merged, backend=args.backend, seed=args.seed,
                device=args.device)
    mode = "merged" if args.merged else "unmerged adapters"
    if res["merge_s"] is not None:
        print(f"merge: {res['merge_s'] * 1e3:.1f} ms")
    print(f"prefill: {res['prefill_s'] * 1e3:.1f} ms  decode: "
          f"{res['per_token_s'] * 1e3:.2f} ms/token ({mode}, "
          f"backend={args.backend}, device={args.device}, "
          f"{res['forwards']} forwards)")
    print(f"dispatch counters: {execute.counters()}")
    print(f"kernel launches: {ops.launches()}")
    print("generated:", res["tokens"][0].tolist())
    return res


if __name__ == "__main__":
    main()
