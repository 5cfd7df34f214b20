"""GQA attention: projections (with adapters), RoPE, causal attention in
float32, and the KV cache of prefill and decode.

The attention itself is plain ``torch.matmul`` and softmax in float32,
as the JAX package's einsum path (``attention_core``, ``_decode_attend``);
the flash kernel is ported in a later slice.  Prefill processes queries
in chunks of ``q_chunk`` so the live score tensor stays
(B, H, q_chunk, T).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.peft import get_adapter
from repro_torch.models.layers import apply_rope, dense, init_dense

Params = dict[str, Any]
_NEG_INF = -1e30


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


def _softmax_attend(qg, k, v, mask):
    """qg (B, G, R, C, D) against k/v (B, G, T, D) under mask (…, C, T)."""
    d = qg.shape[-1]
    logits = (qg.float() @ k.float()[:, :, None].transpose(-1, -2)
              ) * (1.0 / d ** 0.5)
    logits = logits.masked_fill(~mask, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)                     # f32 stats
    p = torch.exp(logits - m)
    z = p.sum(dim=-1, keepdim=True)
    p = p / z.clamp_min(1e-30)
    return p @ v.float()[:, :, None]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0, q_chunk: int = 512) -> torch.Tensor:
    """Exact attention, chunked over queries.

    q: (B, H, S, D); k/v: (B, Hkv, T, D).  Returns (B, H, S, D)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kpos = torch.arange(t, device=q.device)
    outs = []
    for start in range(0, s, q_chunk):
        qc = q[:, :, start:start + q_chunk]
        c = qc.shape[2]
        qpos = q_offset + start + torch.arange(c, device=q.device)
        mask = torch.ones((c, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        out = _softmax_attend(qc.reshape(b, hkv, h // hkv, c, d), k, v, mask)
        outs.append(out.reshape(b, h, c, d))
    return torch.cat(outs, dim=2).to(q.dtype)


def _decode_attend(q, ck, cv, qpos, *, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against the preallocated cache.

    q: (B, H, 1, D); ck/cv: (B, Hkv, T, D); qpos: (B, 1) absolute query
    position; cache slot index == position."""
    b, h, _, d = q.shape
    hkv, t = ck.shape[1], ck.shape[2]
    kpos = torch.arange(t, device=q.device).expand(b, 1, t)
    mask = kpos >= 0
    if causal:
        mask = mask & (kpos <= qpos[:, :, None])
    if window is not None:
        mask = mask & (kpos > qpos[:, :, None] - window)
    qg = q.reshape(b, hkv, h // hkv, 1, d)
    out = _softmax_attend(qg, ck, cv, mask[:, None, None])   # (B,G,R,1,D)
    return out.reshape(b, h, 1, d).to(q.dtype)


def apply_attention(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    head_dim: int, positions: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    rope: Optional[tuple] = None,
                    cache: Optional[Params] = None,
                    cache_pos: Optional[int] = None, q_chunk: int = 512,
                    adapters=None, peft=None):
    """Full attention block: projections (+adapters), RoPE, core, output.

    ``positions`` (B, S) are the tokens' absolute positions; ``rope`` is
    ``layers.rope_tables(positions, head_dim, theta)`` (None: no RoPE).

    * prefill: ``cache=None`` → (out, {'k', 'v'}) of this prompt.
    * decode: ``cache={'k','v'}`` (B, Hkv, T, D) and the scalar cursor
      ``cache_pos`` → writes the new tokens' KV at ``cache_pos`` IN PLACE
      (the JAX package returns an updated copy) and attends over the
      cache; returns (out, cache)."""
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
        out = _decode_attend(q, ck, cv, positions[:, -1:], causal=causal,
                             window=window)
        out = dense(p["o_proj"], _merge_heads(out),
                    adapter=get_adapter(adapters, "o_proj"), peft=peft)
        return out, {"k": ck, "v": cv}

    out = attention_core(q, k, v, causal=causal, window=window,
                         q_chunk=q_chunk)
    out = dense(p["o_proj"], _merge_heads(out),
                adapter=get_adapter(adapters, "o_proj"), peft=peft)
    return out, {"k": k, "v": v}
