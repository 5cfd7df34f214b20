"""Shared neural building blocks: plain tensor functions over param dicts.

Every linear goes through :func:`dense`, which is where the PEFT
adapters attach.  Numerics follow the JAX package: rmsnorm, RoPE and the
output logits run in float32 whatever the compute dtype.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.peft import get_adapter
from repro_torch.core.transforms import PEFTConfig, adapted_dense

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers (same distributions as the JAX package, own random numbers)
# ---------------------------------------------------------------------------

def lecun_normal(generator: torch.Generator, shape, dtype, device,
                 fan_in: int) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * math.sqrt(1.0 / fan_in)).to(dtype)


def init_dense(generator, d_in: int, d_out: int, dtype, device, *,
               bias: bool = False, stack: tuple[int, ...] = ()) -> Params:
    """Kernel (…stack, d_in, d_out) + optional bias."""
    p: Params = {"kernel": lecun_normal(generator, (*stack, d_in, d_out),
                                        dtype, device, d_in)}
    if bias:
        p["bias"] = torch.zeros((*stack, d_out), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor, *, adapter: Optional[Params] = None,
          peft: Optional[PEFTConfig] = None) -> torch.Tensor:
    """y = adapted(W)ᵀx + b — the single PEFT attach point."""
    return adapted_dense(x, p["kernel"], p.get("bias"), adapter, peft)


# ---------------------------------------------------------------------------
# Norms, embeddings, positions
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device, stack: tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def init_embedding(generator, vocab: int, d: int, dtype, device) -> Params:
    t = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=device)
    return {"table": (t * 0.02).to(dtype)}


def embed(p: Params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return p["table"][tokens].to(compute_dtype)


def logits_out(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: x @ tableᵀ, float32 logits."""
    return x.float() @ p["table"].float().T


def rope_tables(positions: torch.Tensor, d: int, theta: float = 10000.0):
    """(cos, sin), each (..., S, d/2) float32, for positions (..., S): the
    same for every layer, so a forward computes them once."""
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, split-half layout, in float32.  x: (..., S, H, D)
    with tables (..., S, D/2), or (..., S, D) with the same tables."""
    if x.dim() == cos.dim() + 1:                             # heads axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D) or (..., S, D); positions (..., S)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Activations / MLPs
# ---------------------------------------------------------------------------

# jax.nn.gelu defaults to the tanh approximation, so "gelu" is tanh here too
ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def init_glu_mlp(generator, d: int, d_ff: int, dtype, device,
                 stack: tuple[int, ...] = ()) -> Params:
    return {
        "gate_proj": init_dense(generator, d, d_ff, dtype, device, stack=stack),
        "up_proj": init_dense(generator, d, d_ff, dtype, device, stack=stack),
        "down_proj": init_dense(generator, d_ff, d, dtype, device, stack=stack),
    }


def glu_mlp(p: Params, x: torch.Tensor, act: str = "silu", *,
            adapters=None, peft=None) -> torch.Tensor:
    g = dense(p["gate_proj"], x, adapter=get_adapter(adapters, "gate_proj"),
              peft=peft)
    u = dense(p["up_proj"], x, adapter=get_adapter(adapters, "up_proj"),
              peft=peft)
    h = ACTS[act](g) * u
    return dense(p["down_proj"], h, adapter=get_adapter(adapters, "down_proj"),
                 peft=peft)


def init_mlp(generator, d: int, d_ff: int, dtype, device, *,
             bias: bool = False, stack: tuple[int, ...] = ()) -> Params:
    return {
        "up_proj": init_dense(generator, d, d_ff, dtype, device, bias=bias,
                              stack=stack),
        "down_proj": init_dense(generator, d_ff, d, dtype, device, bias=bias,
                                stack=stack),
    }


def mlp(p: Params, x: torch.Tensor, act: str = "gelu", *,
        adapters=None, peft=None) -> torch.Tensor:
    h = ACTS[act](dense(p["up_proj"], x,
                        adapter=get_adapter(adapters, "up_proj"), peft=peft))
    return dense(p["down_proj"], h,
                 adapter=get_adapter(adapters, "down_proj"), peft=peft)
