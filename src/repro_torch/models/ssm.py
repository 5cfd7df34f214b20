"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block of the port.

The counterpart of the JAX package's ``models/ssm.py``: the SSD chunked
dual form — intra-chunk attention-like products plus an inter-chunk
linear state scan — O(S·L) compute and O(S) memory with chunk length L.
Prefill runs :func:`ssd_chunked` through ``core.execute``: its chunks on
the hand-written SSD kernel (``kernels/ops.ssd_chunk``) on the card, on
their plain version (``kernels/ref.ref_ssd_chunk``) on the CPU.  Decode
(S == 1 against a cache) is the single-step recurrence in plain PyTorch,
as the JAX package runs it in jnp.

ETHER attaches to ``in_proj`` / ``out_proj`` (the (d×f) linears); conv,
Δ, A, D have no d×f structure and stay frozen (DESIGN.md §5).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import execute
from repro_torch.core.peft import get_adapter
from repro_torch.kernels import ref
from repro_torch.models.layers import dense, init_dense, init_rmsnorm, rmsnorm

Params = dict[str, Any]


def ssm_dims(d_model: int, *, expand: int = 2, headdim: int = 64,
             d_state: int = 128, n_groups: int = 1, conv_width: int = 4):
    d_inner = expand * d_model
    return dict(d_inner=d_inner, headdim=headdim,
                n_heads=d_inner // headdim, d_state=d_state,
                n_groups=n_groups, conv_width=conv_width)


def init_mamba2(generator: torch.Generator, d_model: int, dtype, device, *,
                stack: tuple[int, ...] = (), **kw) -> Params:
    """The JAX package's distributions from ``generator``: lecun-normal
    projections, a 0.1·normal conv kernel (W, C) and zero bias in
    ``dtype``; ``a_log`` 0 (A = −1), ``dt_bias`` 0 and ``d_skip`` 1 in
    float32; every leaf with the leading ``stack`` dims."""
    dims = ssm_dims(d_model, **kw)
    di, h, g, n, w = (dims["d_inner"], dims["n_heads"], dims["n_groups"],
                      dims["d_state"], dims["conv_width"])
    d_in_proj = 2 * di + 2 * g * n + h          # z, x, B, C, dt
    conv_ch = di + 2 * g * n
    f32 = torch.float32
    kernel = torch.randn((*stack, w, conv_ch), generator=generator,
                         dtype=f32, device=device)
    return {
        "in_proj": init_dense(generator, d_model, d_in_proj, dtype, device,
                              stack=stack),
        "conv": {"kernel": (kernel * 0.1).to(dtype),
                 "bias": torch.zeros((*stack, conv_ch), dtype=dtype,
                                     device=device)},
        "a_log": torch.zeros((*stack, h), dtype=f32, device=device),
        "dt_bias": torch.zeros((*stack, h), dtype=f32, device=device),
        "d_skip": torch.ones((*stack, h), dtype=f32, device=device),
        "norm": init_rmsnorm(di, dtype, device, stack),
        "out_proj": init_dense(generator, di, d_model, dtype, device,
                               stack=stack),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 true_lens: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x: (B, S, C); kernel: (W, C).

    Returns (silu(y + bias), new_state), the state holding the last W−1
    inputs for streaming decode.  With right-padded prompts, ``true_lens``
    (B,) makes the streamed tail hold the last W−1 *real* inputs per row
    (DESIGN.md §10): ctx index ``true_lens[b]`` is the first of them, since
    ctx prepends W−1 state/zero entries before x."""
    w, S = kernel.shape[0], x.shape[1]
    if state is None:
        ctx = F.pad(x, (0, 0, w - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(ctx[:, i:i + S] * kernel[i] for i in range(w))
    if w <= 1:
        new_state = x.new_zeros((x.shape[0], 0, x.shape[2]))
    elif true_lens is None:
        new_state = ctx[:, -(w - 1):]
    else:
        idx = (true_lens.to(device=x.device, dtype=torch.long)[:, None]
               + torch.arange(w - 1, device=x.device))        # (B, W−1)
        new_state = torch.gather(
            ctx, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return F.silu(y + bias), new_state


def ssd_chunked(xv, a, b, c, *, chunk: int = 256,
                initial_state: Optional[torch.Tensor] = None,
                intra=ref.ref_ssd_chunk):
    """SSD chunked dual form (the JAX package's ``models.ssm.ssd_chunked``).

    xv: (B, S, H, P) Δ-scaled inputs; a: (B, S, H) log-decay (≤ 0);
    b, c: (B, S, G, N); initial_state (B, H, N, P) or None (zeros).
    S is zero-padded to a multiple of L = min(chunk, S); ``intra`` gives
    each chunk's intra part, summary state and decay — the plain
    ``ref.ref_ssd_chunk`` or the SSD kernel ``ops.ssd_chunk`` — and the
    inter-chunk recurrence and y_inter = exp(cum)·c·state run here in
    PyTorch, as the JAX package runs them in XLA outside its kernel
    (``ops.ssd_chunked_pallas``).  Returns (y (B, S, H, P) in xv's
    dtype, final_state (B, H, N, P) float32)."""
    B, S, H, P = xv.shape
    G, N = b.shape[2], b.shape[3]
    if initial_state is not None and initial_state.shape != (B, H, N, P):
        raise ValueError(f"initial_state must be of shape {(B, H, N, P)}, "
                         f"got {tuple(initial_state.shape)}")
    L = min(chunk, S)
    pad = -S % L
    if pad:
        # zero-pad to a chunk multiple: a=0 ⇒ decay exp(0)=1 and b·x=0,
        # so padded steps pass the state through exactly
        xv = F.pad(xv, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // L
    y_intra, states, decays = intra(xv, a, b, c, L)

    carry = (xv.new_zeros((B, H, N, P), dtype=torch.float32)
             if initial_state is None else initial_state.float())
    prev = []                                   # the state entering chunk k
    for k in range(nc):
        prev.append(carry)
        carry = decays[:, :, k, None, None] * carry + states[:, :, k]
    prev_states = torch.stack(prev, dim=2).view(B, G, H // G, nc, N, P)
    cum = a.float().reshape(B, nc, L, H).cumsum(dim=2)
    y_inter = torch.einsum("bclgn,bgrcnp->bclgrp",
                           c.float().reshape(B, nc, L, G, N), prev_states)
    y_inter = y_inter.reshape(B, nc, L, H, P) * torch.exp(cum)[..., None]
    y = y_intra + y_inter.reshape(B, S + pad, H, P)
    return y[:, :S].to(xv.dtype), carry


def mamba2_block(p: Params, x: torch.Tensor, *, d_model: int,
                 cache: Optional[Params] = None, chunk: int = 256,
                 adapters=None, peft=None,
                 true_lens: Optional[torch.Tensor] = None, **kw):
    """Full Mamba-2 mixer. x: (B, S, d_model).

    cache (decode): {"conv": (B, W−1, C), "ssm": (B, H, N, P)}.
    Returns (out, new_cache).  Casts as in the JAX package: Δ, the
    Δ-scaled inputs and the scan in float32, y cast to the activation
    dtype before the gated rmsnorm.

    ``true_lens`` (B,) makes right-padded prefill pad-invariant
    (DESIGN.md §10): pad positions become identity state updates (a → 0,
    xv → 0) and the streamed conv tail is gathered at the last real
    inputs.  The chunked scan runs on ``peft.backend`` (``auto`` without
    a PEFT config, e.g. merged serving)."""
    dims = ssm_dims(d_model, **kw)
    di, h, g, n, pd = (dims["d_inner"], dims["n_heads"], dims["n_groups"],
                       dims["d_state"], dims["headdim"])
    B, S, _ = x.shape

    zxbcdt = dense(p["in_proj"], x, adapter=get_adapter(adapters, "in_proj"),
                   peft=peft)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * g * n, h], dim=-1)

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv"]["kernel"], p["conv"]["bias"],
                                 conv_state, true_lens=true_lens)
    xs, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)
    b = b.reshape(B, S, g, n)
    c = c.reshape(B, S, g, n)
    xh = xs.reshape(B, S, h, pd)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])           # (B,S,H)
    a = -torch.exp(p["a_log"]) * dt                          # log-decay ≤ 0
    xv = xh.float() * dt[..., None]
    if true_lens is not None:
        valid = (torch.arange(S, device=x.device)[None]
                 < true_lens.to(x.device)[:, None])          # (B,S)
        a = torch.where(valid[..., None], a, 0.0)
        xv = torch.where(valid[..., None, None], xv, 0.0)

    if cache is not None and S == 1:
        # streaming decode: single recurrence step
        state = cache["ssm"].float()                         # (B,H,N,P)
        bh = b[:, 0].float().repeat_interleave(h // g, dim=1)  # (B,H,N)
        chh = c[:, 0].float().repeat_interleave(h // g, dim=1)
        state = (torch.exp(a[:, 0])[..., None, None] * state
                 + bh[..., None] * xv[:, 0, :, None, :])
        y = torch.einsum("bhn,bhnp->bhp", chh, state)[:, None]  # (B,1,H,P)
        final = state
    else:
        init = cache["ssm"] if cache is not None else None
        backend = peft.backend if peft is not None else "auto"
        y, final = execute.dispatch("ssd_chunked", backend, xv, a,
                                    b.contiguous(), c.contiguous(),
                                    chunk=chunk, initial_state=init)

    y = y + p["d_skip"][:, None] * xh.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    out = dense(p["out_proj"], y, adapter=get_adapter(adapters, "out_proj"),
                peft=peft)
    new_cache = {"conv": new_conv.to(x.dtype), "ssm": final.float()}
    return out, new_cache
