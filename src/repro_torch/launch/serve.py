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
  model).  ``vera`` raises NotPortedError;
* ``--tenants N`` (ETHER, ETHER+, DeLoRA, HyperAdapt): static
  multi-tenant serving (DESIGN.md §2).  An N-tenant ``AdapterBank`` (each
  tenant's adapters from a generator of its own) serves the batch
  unmerged, each row with the tenant of a random, validated id, through
  the bank kernels (``householder_gemm_batched``,
  ``etherplus_reflect_batched`` around a plain product,
  ``delora_gemm_batched``, ``hyperadapt_gemm_batched``); then tenant 0
  merged into the weights serves the same batch, and the per-token
  overhead of the bank is printed.  It refuses the other methods and
  ``--merged``.

Weights, adapters and prompts are random, made from ``--seed``.  Runs on
the card (``--device cuda``, the default) and raises when there is none;
``--device cpu`` runs the plain versions on the CPU.  Prints prefill ms,
decode ms per token, the dispatch counters and kernel launches, and the
generated tokens.  ``--trace`` (the continuous-batching engine) is not
ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute, methods
from repro_torch.core.peft import (init_adapter_bank, init_adapters,
                                   merge_params, validate_tenant_ids)
from repro_torch.core.transforms import PEFTConfig
from repro_torch.kernels import ops
from repro_torch.models.api import (decode_step, init_model, pad_cache,
                                    prefill, resolve_device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits[:, -1].argmax(dim=-1, keepdim=True)         # (B, 1)


def generate(params, adapters, tokens, cfg, peft, gen: int,
             tenant_ids=None) -> dict:
    """Prefill + ``gen`` greedy decode steps, after one untimed warm-up
    prefill and step.  ``adapters`` may be an AdapterBank, with one
    tenant id per row in ``tenant_ids``.  Returns prefill seconds,
    seconds per decoded token, the generated tokens (B, gen+1), the timed
    prefill's logits (B, 1, V) and the number of backbone forwards run."""
    device = tokens.device
    max_len = tokens.shape[1] + gen + 1

    def pf():
        cache, logits = prefill(params, adapters, {"tokens": tokens}, cfg,
                                peft, tenant_ids=tenant_ids)
        return pad_cache(cache, cfg, max_len), logits

    cache, logits = pf()
    decode_step(params, adapters, cache, _greedy(logits), cfg, peft,
                tenant_ids=tenant_ids)
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
                                         peft, tenant_ids=tenant_ids)
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
          prompt_len: int = 32, merged: bool = False, tenants: int = 0,
          backend: str = "auto", seed: int = 0, device="cuda") -> dict:
    """The model, adapters and prompts of one serving run, made from
    ``seed``: a dict of ``cfg``, ``peft``, ``params``, ``adapters``,
    ``tokens``, ``tenant_ids`` and ``merge_s``.  With ``merged`` the
    adapters are absorbed into ``params`` (``adapters`` and ``peft`` are
    then None) and ``merge_s`` is the seconds that took, else None.  With
    ``tenants`` the adapters are an AdapterBank of that many tenants and
    ``tenant_ids`` (B,) int32 on the device, validated, pick each row's
    tenant; else ``tenant_ids`` is None."""
    if tenants and merged:
        raise ValueError("a bank serves unmerged; merge one tenant with "
                         "merge_params(params, bank.select(t), peft)")
    dev = resolve_device(device)
    cfg = get_config(arch, variant)
    peft = PEFTConfig(method=method, n_blocks=n_blocks, rank=rank,
                      alpha=float(rank), targets=peft_targets(arch),
                      backend=backend)
    params = init_model(cfg, seed=seed, device=dev)
    tenant_ids = None
    if tenants:
        adapters = init_adapter_bank(seed + 1, params, peft, tenants)
        ids = torch.randint(0, tenants, (batch,),
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed + 3), device=dev)
        tenant_ids = torch.as_tensor(validate_tenant_ids(ids, tenants),
                                     device=dev)
    else:
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
            "adapters": adapters, "tokens": tokens,
            "tenant_ids": tenant_ids, "merge_s": merge_s}


def serve(*, gen: int = 16, **kw) -> dict:
    """Build the model from ``seed`` (keywords of :func:`build`) and
    serve one batch; returns the measurements of :func:`generate` plus
    ``merge_s`` (merged only)."""
    m = build(**kw)
    res = generate(m["params"], m["adapters"], m["tokens"], m["cfg"],
                   m["peft"], gen, tenant_ids=m["tenant_ids"])
    res["merge_s"] = m["merge_s"]
    return res


def serve_tenants(*, gen: int = 16, **kw) -> dict:
    """The ``--tenants`` mode: build a bank (keywords of :func:`build`,
    ``tenants`` > 0) and serve one batch through it unmerged, each row
    with its tenant; then serve the batch with tenant 0 merged into the
    weights.  Returns {"bank": and "merged": measurements of
    :func:`generate` (with each run's dispatch counters and kernel
    launches, counted from 0), "tenant_ids", "bank_bytes", "merge_s"}."""
    m = build(**kw)
    cfg, peft, params, bank = m["cfg"], m["peft"], m["params"], m["adapters"]

    def counted(run):
        execute.reset_counters()
        ops.reset_launches()
        res = run()
        res["counters"], res["launches"] = execute.counters(), ops.launches()
        return res

    out = {"tenant_ids": m["tenant_ids"], "bank_bytes": bank.size_bytes()}
    out["bank"] = counted(lambda: generate(params, bank, m["tokens"], cfg,
                                           peft, gen,
                                           tenant_ids=m["tenant_ids"]))

    def merged():
        t0 = time.perf_counter()
        mp = merge_params(params, bank.select(0), peft)
        _sync(m["tokens"].device)
        out["merge_s"] = time.perf_counter() - t0
        return generate(mp, None, m["tokens"], cfg, None, gen)
    out["merged"] = counted(merged)
    return out


def _main_tenants(args) -> dict:
    if args.method not in methods.bank_servable():
        raise SystemExit(f"--tenants requires a bank-servable --method "
                         f"({', '.join(methods.bank_servable())}); banks "
                         f"gather per-request adapter rows")
    if args.merged:
        raise SystemExit("--merged conflicts with --tenants: the tenants "
                         "mode already runs the merged baseline alongside "
                         "the unmerged bank")
    res = serve_tenants(arch=args.arch, variant=args.variant,
                        method=args.method, n_blocks=args.n_blocks,
                        rank=args.rank, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen,
                        tenants=args.tenants, backend=args.backend,
                        seed=args.seed, device=args.device)
    kb = res["bank_bytes"] / 1e3
    print(f"adapter bank [{args.method}]: {args.tenants} tenants = "
          f"{kb:.1f} KB ({kb / args.tenants:.2f} KB/tenant) on "
          f"{args.device}")
    print(f"request tenant ids: {res['tenant_ids'].tolist()}")
    bank, mg = res["bank"], res["merged"]
    print(f"[unmerged bank]  prefill: {bank['prefill_s'] * 1e3:.1f} ms  "
          f"decode: {bank['per_token_s'] * 1e3:.2f} ms/token "
          f"(backend={args.backend}, {bank['forwards']} forwards)")
    print(f"    dispatch counters: {bank['counters']}")
    print(f"    kernel launches: {bank['launches']}")
    print(f"[merged t=0]     prefill: {mg['prefill_s'] * 1e3:.1f} ms  "
          f"decode: {mg['per_token_s'] * 1e3:.2f} ms/token (merge "
          f"{res['merge_s'] * 1e3:.1f} ms)")
    print(f"    dispatch counters: {mg['counters']}")
    print(f"    kernel launches: {mg['launches']}")
    overhead = bank["per_token_s"] / max(mg["per_token_s"], 1e-9) - 1
    print(f"unmerged-bank overhead: {overhead * 100:+.1f}% per decoded "
          f"token for {args.tenants}-tenant isolation")
    print("generated:", bank["tokens"][0].tolist())
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
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve the batch from an adapter bank of this many "
                         "tenants, against tenant 0 merged")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    if args.trace:
        raise SystemExit("--trace (the continuous-batching serve engine) is "
                         "not yet ported, see ROADMAP.md")
    if args.tenants:
        return _main_tenants(args)

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
