"""Decoder-only LM backbone of the port: dense attention layers
(``block_pattern=("attn",)``) with a swiglu or gelu MLP, and Mamba-2
layers (``("ssd",)``, ``mlp_type="none"``: the mixer alone, as the JAX
package's ``_init_layer`` builds it).

Params keep the JAX package's stacked layout: every per-layer leaf of
``units/pos0/...`` carries a leading ``n_layers`` axis, and so do the
adapters and the serving cache (attention ``pos0/k``: (L, B, Hkv, T, D);
Mamba-2 ``pos0/conv``: (L, B, W−1, C) and ``pos0/ssm``: (L, B, H, N, P)
float32).  ``forward`` walks the layers in a Python loop over views of
those stacks; in training (``mode="train"``) with ``cfg.remat == "full"``
each layer runs under ``torch.utils.checkpoint``, the counterpart of the
JAX package's ``jax.checkpoint`` of its scanned layer.  Mamba-2 serves
only: training an ``ssd`` config raises NotPortedError (its SSD kernel
has no backward yet).  Other block types, MoE and the frontends are
queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import NotPortedError
from repro_torch.common.dtypes import torch_dtype
from repro_torch.core.peft import get_adapter
from repro_torch.models import layers as L
from repro_torch.models.attention import apply_attention, init_attention
from repro_torch.models.ssm import init_mamba2, mamba2_block, ssm_dims

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field for field the JAX package's ``ModelConfig``."""
    name: str = "model"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0                      # 0 → d_model // n_heads
    block_pattern: tuple[str, ...] = ("attn",)
    mlp_type: str = "swiglu"               # swiglu | gelu | moe | none
    act: str = "silu"
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    norm: str = "rmsnorm"
    window: Optional[int] = None           # local_attn sliding window
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_headdim: int = 64
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # RG-LRU
    rnn_width: int = 0                     # 0 → d_model
    rnn_heads: int = 0                     # 0 → n_heads
    # frontends
    frontend: Optional[str] = None         # "vision" | None
    n_img_tokens: int = 0
    d_frontend: int = 1024
    # misc
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "full"                    # full | none
    q_chunk: int = 512
    loss_chunk: int = 0                    # 0 = unchunked CE
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pdt(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def cdt(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotPortedError for what this backbone does not run yet."""
    if tuple(cfg.block_pattern) not in (("attn",), ("ssd",)):
        raise NotPortedError(f"block pattern {cfg.block_pattern}")
    if cfg.mlp_type not in ("swiglu", "gelu", "none"):
        raise NotPortedError(f"mlp_type {cfg.mlp_type!r}")
    if cfg.frontend is not None:
        raise NotPortedError(f"the {cfg.frontend!r} frontend")
    if cfg.window is not None:
        raise NotPortedError("sliding-window attention")
    if cfg.norm != "rmsnorm":
        raise NotPortedError(f"norm {cfg.norm!r}")
    if cfg.remat not in ("full", "none"):
        raise NotPortedError(f"remat policy {cfg.remat!r}")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise NotPortedError for what the port serves but does not train:
    the Mamba-2 ``ssd`` block, whose SSD kernel has no backward (its
    output would carry no gradient to ``in_proj``'s adapter)."""
    check_supported(cfg)
    if "ssd" in cfg.block_pattern:
        raise NotPortedError("training the Mamba-2 'ssd' block")


def _ssm_kw(cfg: ModelConfig) -> dict:
    return dict(expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                d_state=cfg.ssm_state, n_groups=cfg.ssm_groups)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random weights of the JAX package's distributions (lecun-normal
    kernels, 0.02·normal embedding, unit norms) from ``generator``, which
    must live on ``device``."""
    check_supported(cfg)
    pdt, stack = cfg.pdt(), (cfg.n_layers,)
    layer: Params = {"norm1": L.init_rmsnorm(cfg.d_model, pdt, device, stack)}
    if cfg.block_pattern[0] == "ssd":
        layer["mixer"] = init_mamba2(generator, cfg.d_model, pdt, device,
                                     stack=stack, **_ssm_kw(cfg))
    else:
        layer["mixer"] = init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, pdt,
            device, qkv_bias=cfg.qkv_bias, stack=stack)
    if cfg.mlp_type != "none":
        layer["norm2"] = L.init_rmsnorm(cfg.d_model, pdt, device, stack)
    if cfg.mlp_type == "swiglu":
        layer["mlp"] = L.init_glu_mlp(generator, cfg.d_model, cfg.d_ff, pdt,
                                      device, stack)
    elif cfg.mlp_type == "gelu":
        layer["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, pdt,
                                  device, stack=stack)
    params = {"embed": L.init_embedding(generator, cfg.vocab, cfg.d_model,
                                        pdt, device),
              "final_norm": L.init_rmsnorm(cfg.d_model, pdt, device),
              "units": {"pos0": layer}}
    if not cfg.tie_embeddings:
        # drawn last, so a tied config's weights are what they were
        params["lm_head"] = L.init_dense(generator, cfg.d_model, cfg.vocab,
                                         pdt, device)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    """Preallocated serving cache for the whole stack; the cursor is a
    Python int (the next position to write).  Mamba-2 layers keep their
    fixed-size recurrent state, whatever ``max_len``."""
    check_supported(cfg)
    n, cdt = cfg.n_layers, cfg.cdt()
    if cfg.block_pattern[0] == "ssd":
        d = ssm_dims(cfg.d_model, **_ssm_kw(cfg))
        conv_ch = d["d_inner"] + 2 * d["n_groups"] * d["d_state"]
        layer = {"conv": torch.zeros((n, batch, d["conv_width"] - 1,
                                      conv_ch), dtype=cdt, device=device),
                 "ssm": torch.zeros((n, batch, d["n_heads"], d["d_state"],
                                     d["headdim"]), dtype=torch.float32,
                                    device=device)}
    else:
        shape = (n, batch, cfg.n_kv, max_len, cfg.hd)
        layer = {"k": torch.zeros(shape, dtype=cdt, device=device),
                 "v": torch.zeros(shape, dtype=cdt, device=device)}
    return {"cursor": 0, "pos0": layer}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _unstack(tree, n: int) -> list:
    """n per-layer trees of views into a tree of stacked tensors."""
    if tree is None:
        return [None] * n
    if not isinstance(tree, dict):
        return list(torch.unbind(tree, 0))
    per_key = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: per_key[k][i] for k in tree} for i in range(n)]


def _apply_layer(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 rope=None, cache=None, cache_pos=None, adapters=None,
                 peft=None, true_lens=None):
    """Pre-norm residual block: mixer + optional MLP.  Returns (x, layer
    cache).  ``true_lens`` (B,) marks each row's real prompt length under
    right-padded prefill: the Mamba-2 mixer makes pad positions identity
    state updates (DESIGN.md §10); attention ignores it, causal masking
    already hides pad KV."""
    h = L.rmsnorm(p["norm1"], x)
    a_mixer = get_adapter(adapters, "mixer")
    if cfg.block_pattern[0] == "ssd":
        mixed, new_cache = mamba2_block(
            p["mixer"], h, d_model=cfg.d_model, cache=cache,
            chunk=cfg.ssm_chunk, adapters=a_mixer, peft=peft,
            true_lens=true_lens, **_ssm_kw(cfg))
    else:
        mixed, new_cache = apply_attention(
            p["mixer"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.hd, causal=True, rope=rope,
            cache=cache, cache_pos=cache_pos, q_chunk=cfg.q_chunk,
            adapters=a_mixer, peft=peft)
    x = x + mixed
    if cfg.mlp_type == "none":
        return x, new_cache
    h2 = L.rmsnorm(p["norm2"], x)
    a_mlp = get_adapter(adapters, "mlp")
    if cfg.mlp_type == "swiglu":
        out = L.glu_mlp(p["mlp"], h2, cfg.act, adapters=a_mlp, peft=peft)
    else:
        out = L.mlp(p["mlp"], h2, cfg.act, adapters=a_mlp, peft=peft)
    return x + out, new_cache


def _layer_out(p, x, cfg, rope, adapters, peft):
    return _apply_layer(p, x, cfg, rope=rope, adapters=adapters,
                        peft=peft)[0]


def _train_layer(p, x, cfg, rope, adapters, peft):
    """One layer of a training forward; under ``remat="full"`` its
    activations are dropped and recomputed in the backward."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(_layer_out, p, x, cfg, rope, adapters, peft,
                          use_reentrant=False, preserve_rng_state=False)
    return _layer_out(p, x, cfg, rope, adapters, peft)


def forward(params: Params, cfg: ModelConfig, *, tokens: torch.Tensor,
            adapters=None, peft=None, mode: str = "prefill", cache=None,
            true_lens: Optional[torch.Tensor] = None):
    """Run the backbone.

    mode='prefill': tokens (B, S) from position 0; returns the prompt's
    cache (attention KV, Mamba-2 conv tail and state) as a new cache;
    ``true_lens`` (B,), prefill only, gives each right-padded row's real
    length.  mode='decode': tokens (B, S) against ``cache``, written in
    place at its cursor (attention KV) or replaced in place (Mamba-2
    state).  mode='train': the full sequence from position 0, no cache
    kept (None), each layer rematerialised in the backward when
    ``cfg.remat == "full"``.  Returns (hidden (B, S, d), cache)."""
    if mode not in ("prefill", "decode", "train"):
        raise NotPortedError(f"backbone mode {mode!r}")
    if true_lens is not None and mode != "prefill":
        raise ValueError("true_lens only applies to prefill mode")
    if mode == "train":
        check_trainable(cfg)
    check_supported(cfg)
    x = L.embed(params["embed"], tokens, cfg.cdt())
    B, S = x.shape[:2]
    start = cache["cursor"] if mode == "decode" else 0
    positions = (start + torch.arange(S, device=x.device)).expand(B, S)
    rope = (None if cfg.rope_theta is None
            else L.rope_tables(positions, cfg.hd, cfg.rope_theta))

    n = cfg.n_layers
    layer_params = _unstack(params["units"]["pos0"], n)
    layer_adapters = _unstack(get_adapter(adapters, "units", "pos0"), n)
    if mode == "train":
        for i in range(n):
            x = _train_layer(layer_params[i], x, cfg, rope,
                             layer_adapters[i], peft)
        return L.rmsnorm(params["final_norm"], x), None
    layer_caches = _unstack(cache["pos0"] if mode == "decode" else None, n)
    new = []
    for i in range(n):
        x, lc = _apply_layer(layer_params[i], x, cfg, rope=rope,
                             cache=layer_caches[i],
                             cache_pos=start if mode == "decode" else None,
                             adapters=layer_adapters[i], peft=peft,
                             true_lens=true_lens)
        if mode == "decode" and cfg.block_pattern[0] == "ssd":
            for k, leaf in lc.items():          # the next state, in place
                layer_caches[i][k].copy_(leaf)
        new.append(lc)
    x = L.rmsnorm(params["final_norm"], x)
    if mode == "decode":
        return x, {"cursor": start + S, "pos0": cache["pos0"]}
    return x, {"cursor": S, "pos0": {k: torch.stack([lc[k] for lc in new])
                                     for k in new[0]}}


def logits_fn(params: Params, cfg: ModelConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """float32 logits: the tied head (hidden @ embedding tableᵀ), or the
    untied ``lm_head`` (d_model, vocab) as hidden @ kernel in float32."""
    if cfg.tie_embeddings:
        return L.logits_out(params["embed"], hidden)
    return hidden.float() @ params["lm_head"]["kernel"].float()


def lm_loss(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
            labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean next-token cross-entropy on float32 logits.  With
    ``cfg.loss_chunk`` < S the sequence is taken ``loss_chunk`` positions
    at a time, each chunk rematerialised in the backward, so the
    (B, S, V) logits only ever exist (B, chunk, V) at a time."""
    B, S, _ = hidden.shape
    mask = (torch.ones((B, S), dtype=torch.float32, device=hidden.device)
            if mask is None else mask.float())
    chunk = cfg.loss_chunk
    if not chunk or S <= chunk:
        tot, cnt = _ce_sum(params, cfg, hidden, labels, mask)
        return tot / cnt.clamp_min(1.0)
    tot = cnt = 0.0
    for s0 in range(0, S, chunk):
        args = (params, cfg, hidden[:, s0:s0 + chunk],
                labels[:, s0:s0 + chunk], mask[:, s0:s0 + chunk])
        t, c = (checkpoint(_ce_sum, *args, use_reentrant=False,
                           preserve_rng_state=False)
                if torch.is_grad_enabled() else _ce_sum(*args))
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)


def _ce_sum(params, cfg, h, y, m):
    """(Σ (logsumexp − gold logit)·mask, Σ mask) over one chunk."""
    logits = logits_fn(params, cfg, h)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         y.reshape(-1).long(), reduction="none")
    return (ce * m.reshape(-1)).sum(), m.sum()
