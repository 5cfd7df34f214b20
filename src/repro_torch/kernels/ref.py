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


def norm_chain(u: torch.Tensor, ghat: torch.Tensor) -> torch.Tensor:
    """Pull dL/dû back through û = u/(‖u‖+ε) on the last axis (f32):
    du = ĝ/s − (u·ĝ) u/(r s²), r = ‖u‖, s = r + ε — exactly what AD of
    :func:`unit` gives (JAX: ``repro.kernels.reflect_bwd.norm_chain``)."""
    r = torch.sqrt((u * u).sum(dim=-1, keepdim=True))
    s = r + EPS
    dot = (u * ghat).sum(dim=-1, keepdim=True)
    return ghat / s - dot * u / (r * s * s)


def ref_reflect_gemm_dx(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                        g: torch.Tensor):
    """(dx, du) of y = reflect(x) @ w under cotangent g, in float32:
    dXr = g·wᵀ, dx = R(dXr) in x's dtype, and du = norm_chain(u, ĝ) with
    ĝ = −2 Σ_t [(ûᵀx_t) dXr_t + (ûᵀdXr_t) x_t], in u's dtype.
    x: (T, d); w: (d, f); u: (n, db); g: (T, f)."""
    n, db = u.shape
    t = x.shape[0]
    uf = u.float()
    uh = unit(uf)
    dxr = (g.float() @ w.float().T).reshape(t, n, db)
    xb = x.float().reshape(t, n, db)
    pg = torch.einsum("tnb,nb->tn", dxr, uh)
    px = torch.einsum("tnb,nb->tn", xb, uh)
    dx = (dxr - 2.0 * pg[..., None] * uh).reshape(x.shape).to(x.dtype)
    ghat = -2.0 * (torch.einsum("tn,tnb->nb", px, dxr)
                   + torch.einsum("tn,tnb->nb", pg, xb))
    return dx, norm_chain(uf, ghat).to(u.dtype)


def ref_reflect_gemm_dw(x: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                        w_dtype: torch.dtype) -> torch.Tensor:
    """dW = reflect(x)ᵀ @ g in float32, rounded once to ``w_dtype``.
    x: (T, d); u: (n, db); g: (T, f)."""
    return (_reflect_f32(x, u).T @ g.float()).to(w_dtype)


def ref_householder_gemm_bwd(x: torch.Tensor, w: torch.Tensor,
                             u: torch.Tensor, g: torch.Tensor, *,
                             need_dw: bool = True):
    """(dx, dw, du) for y = reflect(x) @ w under cotangent g (the JAX
    package's ``ref_householder_gemm_bwd``); dw is None unless
    ``need_dw``.  x: (..., d); g: (..., f)."""
    d, f = w.shape
    x2, g2 = x.reshape(-1, d), g.reshape(-1, f)
    dx, du = ref_reflect_gemm_dx(x2, w, u, g2)
    dw = ref_reflect_gemm_dw(x2, u, g2, w.dtype) if need_dw else None
    return dx.reshape(x.shape), dw, du
