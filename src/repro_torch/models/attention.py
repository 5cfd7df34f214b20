"""GQA attention: projections (with adapters), RoPE, causal attention in
float32, and the KV cache of prefill and decode.

Attention (prefill and every decode step) goes through
``execute.dispatch("flash_attention", backend, ...)`` with the backend of
``peft.backend``: ``cuda`` runs the hand-written flash kernel, ``torch``
its plain version (``ref.ref_flash_attention``, the JAX package's einsum
``attention_core`` and ``_decode_attend``), which processes queries in
chunks of ``q_chunk`` so the live score tensor stays (B, H, q_chunk, T).
When an operand requires grad (training), :func:`attention_core`
dispatches the ``torch`` route under autograd, counted as
``flash_attention.torch``: the kernel has no backward, as the Pallas
kernel has none.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import execute
from repro_torch.core.peft import get_adapter
from repro_torch.models.layers import apply_rope, dense, init_dense

Params = dict[str, Any]


def init_attention(generator, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype, device, *, qkv_bias: bool = False,
                   stack: tuple[int, ...] = ()) -> Params:
    kw = dict(bias=qkv_bias, stack=stack)
    return {
        "q_proj": init_dense(generator, d_model, n_heads * head_dim, dtype,
                             device, **kw),
        "k_proj": init_dense(generator, d_model, n_kv * head_dim, dtype,
                             device, **kw),
        "v_proj": init_dense(generator, d_model, n_kv * head_dim, dtype,
                             device, **kw),
        "o_proj": init_dense(generator, n_heads * head_dim, d_model, dtype,
                             device, stack=stack),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1).transpose(1, 2)             # (B, H, S, D)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0, q_chunk: int = 512,
                   backend: str = "auto") -> torch.Tensor:
    """Exact attention of q (B, H, S, D) against k/v (B, Hkv, T, D), query
    row i at ``q_offset + i``; returns (B, H, S, D).  Dispatched as
    ``flash_attention`` on ``backend``, and on ``torch`` when an operand
    requires grad (the plain version under autograd).  Decode passes the
    host cursor as ``q_offset``: the cache slots past it are masked by
    causality."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        backend = "torch"
    return execute.dispatch("flash_attention", backend, q.contiguous(),
                            k.contiguous(), v.contiguous(), causal=causal,
                            window=window, q_offset=q_offset,
                            q_chunk=q_chunk)


def apply_attention(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    head_dim: int, causal: bool = True,
                    window: Optional[int] = None,
                    rope: Optional[tuple] = None,
                    cache: Optional[Params] = None,
                    cache_pos: Optional[int] = None, q_chunk: int = 512,
                    adapters=None, peft=None):
    """Full attention block: projections (+adapters), RoPE, core, output.

    ``rope`` is ``layers.rope_tables(positions, head_dim, theta)`` of the
    tokens' absolute positions (None: no RoPE).

    * prefill: ``cache=None`` → (out, {'k', 'v'}) of this prompt.
    * decode: ``cache={'k','v'}`` (B, Hkv, T, D) and the scalar cursor
      ``cache_pos`` → writes the new tokens' KV at ``cache_pos`` IN PLACE
      (the JAX package returns an updated copy) and attends over the
      cache; returns (out, cache)."""
    backend = peft.backend if peft is not None else "auto"
    q = dense(p["q_proj"], x, adapter=get_adapter(adapters, "q_proj"),
              peft=peft)
    k = dense(p["k_proj"], x, adapter=get_adapter(adapters, "k_proj"),
              peft=peft)
    v = dense(p["v_proj"], x, adapter=get_adapter(adapters, "v_proj"),
              peft=peft)
    q = _split_heads(q, n_heads)
    k = _split_heads(k, n_kv)
    v = _split_heads(v, n_kv)
    if rope is not None:
        # tables (B, S, D/2); apply_rope wants (B, S, H, D)
        q = apply_rope(q.transpose(1, 2), *rope).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), *rope).transpose(1, 2)

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        s = k.shape[2]
        if cache_pos + s > ck.shape[2]:
            raise ValueError(f"decode past the cache: position "
                             f"{cache_pos} + {s} > {ck.shape[2]} slots "
                             f"(grow it with api.pad_cache)")
        ck[:, :, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, :, cache_pos:cache_pos + s] = v.to(cv.dtype)
        out = attention_core(q, ck, cv, causal=causal, window=window,
                             q_offset=cache_pos, backend=backend)
        out = dense(p["o_proj"], _merge_heads(out),
                    adapter=get_adapter(adapters, "o_proj"), peft=peft)
        return out, {"k": ck, "v": cv}

    out = attention_core(q, k, v, causal=causal, window=window,
                         q_chunk=q_chunk, backend=backend)
    out = dense(p["o_proj"], _merge_heads(out),
                adapter=get_adapter(adapters, "o_proj"), peft=peft)
    return out, {"k": k, "v": v}
