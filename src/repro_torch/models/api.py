"""Model API of the port — the serving and training CLIs,
``chip_smoke.py`` and the tests go through these entry points:

    init_model(cfg, seed=, device=)              → params
    train_loss(params, adapters, batch, cfg, peft) → (loss, metrics)
    prefill(params, adapters, batch, cfg, peft, tenant_ids=)
                                                 → (cache, last logits)
    pad_cache(cache, cfg, max_len)               → cache with room to decode
    decode_step(params, adapters, cache, tokens, cfg, peft, tenant_ids=)
                                                 → (logits, cache)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no such request they raise (never move to the CPU on
their own).  Logits are (B, 1, V) float32.  Multi-tenant serving passes
an :class:`~repro_torch.core.peft.AdapterBank` as ``adapters`` and one
tenant id per batch row as ``tenant_ids``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.transforms import PEFTConfig
from repro_torch.models import backbone
from repro_torch.models.backbone import ModelConfig

Params = dict[str, Any]


class DeviceUnavailableError(RuntimeError):
    """The requested device is not present."""


def resolve_device(device="cuda") -> torch.device:
    """The torch device for ``device``; raises if it is a CUDA device and
    this process sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random params from ``seed`` on ``device`` (see backbone.init)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return backbone.init(gen, cfg, dev)


def train_loss(params: Params, adapters: Optional[Params], batch: dict,
               cfg: ModelConfig, peft: Optional[PEFTConfig]):
    """Next-token cross-entropy of ``batch['tokens']`` (B, S) against
    ``batch['labels']`` (B, S), masked by ``batch['mask']`` if given.
    Returns (loss, {"loss": loss}); differentiable, so it runs with
    autograd on.  Raises NotPortedError for a Mamba-2 (``ssd``) config,
    which the port serves but does not train yet."""
    hidden, _ = backbone.forward(params, cfg, tokens=batch["tokens"],
                                 adapters=adapters, peft=peft, mode="train")
    loss = backbone.lm_loss(params, cfg, hidden, batch["labels"],
                            batch.get("mask"))
    return loss, {"loss": loss}


def validate_true_lens(true_lens, seq_len: int) -> np.ndarray:
    """Host-side guard for right-padded prefill: every length must lie in
    [1, seq_len] — 0 would gather the last padded column and > seq_len the
    wrong token.  Returns int32 numpy."""
    if isinstance(true_lens, torch.Tensor):
        true_lens = true_lens.cpu().numpy()
    arr = np.asarray(true_lens)
    if arr.size and not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"true_lens must be integers, got {arr.dtype}")
    bad = arr[(arr < 1) | (arr > seq_len)] if arr.size else arr
    if bad.size:
        raise ValueError(f"true_lens {sorted(set(bad.tolist()))} out of "
                         f"range [1, {seq_len}] — 0 would gather the "
                         f"last padded column, > seq_len the wrong "
                         f"token")
    return arr.astype(np.int32)


def _resolve_adapters(adapters, tenant_ids):
    """Multi-tenant serving: an AdapterBank and one tenant id per batch
    row become a request's adapter tree (the bank and the ids at every
    module); any other adapter tree passes through.  A bank needs ids,
    and ids need a bank."""
    from repro_torch.core.peft import AdapterBank
    if isinstance(adapters, AdapterBank):
        if tenant_ids is None:
            raise ValueError("AdapterBank serving requires tenant_ids "
                             "(one int32 id per batch row)")
        return adapters.request(tenant_ids)
    if tenant_ids is not None and adapters is not None:
        raise ValueError("tenant_ids only applies to AdapterBank adapters")
    return adapters


@torch.no_grad()
def prefill(params: Params, adapters: Optional[Params], batch: dict,
            cfg: ModelConfig, peft: Optional[PEFTConfig], tenant_ids=None,
            true_lens=None):
    """Build the serving cache from a full prompt ``batch['tokens']``
    (B, P); returns (cache, logits (B, 1, V) f32 at each row's last real
    token: position ``true_lens[b] - 1``, or P - 1 without true_lens).
    With a bank as ``adapters``, row b is served by tenant
    ``tenant_ids[b]``.  ``true_lens`` (B,) serves right-padded prompts:
    causal masking keeps the pads out of attention, and the Mamba-2
    mixer turns them into identity state updates, so the returned cache
    is the unpadded prompt's (DESIGN.md §10)."""
    adapters = _resolve_adapters(adapters, tenant_ids)
    tokens = batch["tokens"]
    lens = None
    if true_lens is not None:
        lens = torch.as_tensor(validate_true_lens(true_lens, tokens.shape[1]),
                               dtype=torch.long, device=tokens.device)
    hidden, cache = backbone.forward(params, cfg, tokens=tokens,
                                     adapters=adapters, peft=peft,
                                     mode="prefill", true_lens=lens)
    if true_lens is None:
        return cache, backbone.logits_fn(params, cfg, hidden[:, -1:])
    idx = lens - 1
    last = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                  idx][:, None]                               # (B, 1, d)
    return cache, backbone.logits_fn(params, cfg, last)


@torch.no_grad()
def pad_cache(cache: Params, cfg: ModelConfig, max_len: int) -> Params:
    """Grow a prefill-sized KV cache to ``max_len`` positions (zero
    padded on the time axis) so decode can append.  A Mamba-2 cache
    (``conv``, ``ssm``) is fixed-size already and comes back as it is."""
    if "k" not in cache["pos0"]:
        return cache
    k = cache["pos0"]["k"]                                 # (L, B, H, T, D)
    t = k.shape[-2]
    if t >= max_len:
        return cache
    out = backbone.init_cache(cfg, k.shape[1], max_len, k.device)
    for name, leaf in cache["pos0"].items():
        out["pos0"][name][..., :t, :] = leaf
    out["cursor"] = cache["cursor"]
    return out


@torch.no_grad()
def decode_step(params: Params, adapters: Optional[Params], cache: Params,
                tokens: torch.Tensor, cfg: ModelConfig,
                peft: Optional[PEFTConfig], tenant_ids=None):
    """One serving step: (B, 1) new tokens against the cache.  The KV of
    the new tokens is written into ``cache`` in place; returns
    (logits (B, 1, V) f32, cache with its cursor advanced).  With a bank
    as ``adapters``, row b is served by tenant ``tenant_ids[b]``."""
    adapters = _resolve_adapters(adapters, tenant_ids)
    hidden, new_cache = backbone.forward(params, cfg, tokens=tokens,
                                         adapters=adapters, peft=peft,
                                         mode="decode", cache=cache)
    return backbone.logits_fn(params, cfg, hidden), new_cache
