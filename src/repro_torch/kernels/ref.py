"""Plain PyTorch versions of the port's CUDA kernels.

The CPU tests hold these against the JAX package, and ``chip_smoke.py``
holds each CUDA kernel against its plain version on the card.  Like the
kernels (and the Pallas kernels they replace), they compute in float32
and cast the result once to the input's dtype; the JAX package's jnp
path instead casts û to the activation dtype first, which only differs
under bf16.
"""

from __future__ import annotations

import torch

EPS = 1e-8     # û = u / (‖u‖ + EPS): ε outside the square root, as in JAX


def unit(u: torch.Tensor) -> torch.Tensor:
    """Normalise the last axis to unit length (paper: û = u/‖u‖)."""
    return u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + EPS)


def _reflect_f32(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """H_B x in float32; x: (..., d), u: (n, db) raw, d = n*db."""
    n, db = u.shape
    uh = unit(u.float())
    xb = x.float().reshape(*x.shape[:-1], n, db)
    proj = torch.einsum("...nb,nb->...n", xb, uh)
    return (xb - 2.0 * proj[..., None] * uh).reshape(x.shape)


def ref_ether_reflect(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Block-diagonal Householder reflection H_B x of the last dim."""
    return _reflect_f32(x, u).to(x.dtype)


def ref_householder_gemm(x: torch.Tensor, w: torch.Tensor,
                         u: torch.Tensor) -> torch.Tensor:
    """Fused (H_B W)ᵀx: y = reflect(x) @ W.  x: (..., d); w: (d, f)."""
    return (_reflect_f32(x, u) @ w.float()).to(x.dtype)


def ref_ether_merge(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Weight-side block-diagonal reflection W' = H_B W.  w: (d, f)."""
    n, db = u.shape
    d, f = w.shape
    uh = unit(u.float())
    wb = w.float().reshape(n, db, f)
    proj = torch.einsum("nb,nbf->nf", uh, wb)
    return (wb - 2.0 * uh[:, :, None] * proj[:, None, :]).reshape(d, f).to(
        w.dtype)
