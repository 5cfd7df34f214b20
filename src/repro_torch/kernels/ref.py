"""Plain PyTorch versions of the port's CUDA kernels.

The CPU tests hold these against the JAX package, and ``chip_smoke.py``
holds each CUDA kernel against its plain version on the card.  Like the
kernels (and the Pallas kernels they replace), they compute in float32
and cast the result once to the input's dtype; the JAX package's jnp
path instead casts û (and, for ETHER+, the pre-epilogue y) to the
activation dtype first, which only differs under bf16.

ETHER+ replaces the reflection by the blockwise rank-2 update
H⁺x = x − û(ûᵀx) + v̂(v̂ᵀx), both projections read off the original x.

The bank versions (``ref_*_batched``, multi-tenant serving) serve
sequence b of x (B, S, d) with tenant ids[b] of a bank whose tenant axis
is first; an id outside [0, A) is mapped into it as the JAX package's
gather maps an index (and the kernels do): from the end if negative, then
clamped.  Their backwards (training through a bank) return what the
Pallas kernels return — dx and the per-sequence dL/dû — and
:func:`bank_grad` finishes them as the JAX package's ``ops._bank_grad``
does, scatter-adding over the ids mapped as the forward maps them (the
registry's ``ref_ether_reflect_batched_bwd`` returns them finished).

DeLoRA (``y = xW + ((x a)·s) b``) and HyperAdapt (``y = ((x·r) W)·c``)
take their scales as given: DeLoRA's s is the method layer's primal, in
the activation dtype (the weight's for the merge), so these never
re-derive its norm chain.  Their backwards compose the steps of the JAX
package's ``ops.delora_gemm_bwd`` / ``ops.hyperadapt_gemm_bwd`` with the
same intermediate roundings.

The merges' backwards (weight-mode training) use the kernels' explicit
formulas, not autograd: the left merge's is the reflection backward of
W's columns (``ref_merge_left_bwd``), the right merge's that of W's rows
(``ref_etherplus_reflect_bwd``).
"""

from __future__ import annotations

from typing import Optional

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


def _rank2_f32(x: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """H⁺x in float32; x: (..., d), u, v: (n, db) raw, d = n*db."""
    n, db = u.shape
    uh, vh = unit(u.float()), unit(v.float())
    xb = x.float().reshape(*x.shape[:-1], n, db)
    pu = torch.einsum("...nb,nb->...n", xb, uh)
    pv = torch.einsum("...nb,nb->...n", xb, vh)
    return (xb - pu[..., None] * uh + pv[..., None] * vh).reshape(x.shape)


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


def ref_etherplus_reflect(x: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Blockwise rank-2 update H⁺x of the last dim."""
    return _rank2_f32(x, u, v).to(x.dtype)


def ref_etherplus_gemm(x: torch.Tensor, w: torch.Tensor, u1: torch.Tensor,
                       v1: torch.Tensor, u2: Optional[torch.Tensor] = None,
                       v2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = (H⁺x) @ W, and with u2/v2 (n_out, db_out) the two-sided output
    update y·H̃⁺ applied to the float32 product before the one rounding,
    as ``_ep_gemm_kernel_2s`` does.  x: (..., d); w: (d, f)."""
    y = _rank2_f32(x, u1, v1) @ w.float()
    if u2 is not None:
        y = _rank2_f32(y, u2, v2)
    return y.to(x.dtype)


def ref_etherplus_merge_left(w: torch.Tensor, u: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """W' = H⁺·W on the input dim (row blocks of db).  w: (d, f)."""
    n, db = u.shape
    d, f = w.shape
    uh, vh = unit(u.float()), unit(v.float())
    wb = w.float().reshape(n, db, f)
    pu = torch.einsum("nb,nbf->nf", uh, wb)
    pv = torch.einsum("nb,nbf->nf", vh, wb)
    return (wb - uh[:, :, None] * pu[:, None, :]
            + vh[:, :, None] * pv[:, None, :]).reshape(d, f).to(w.dtype)


def ref_etherplus_merge_right(w: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """W' = W·H̃⁺ on the output dim (column blocks of db_out): each row of
    W takes the rank-2 update.  w: (d, f); u, v: (n_out, db_out)."""
    return ref_etherplus_reflect(w, u, v)


def ref_etherplus_merge(w: torch.Tensor, u1: torch.Tensor, v1: torch.Tensor,
                        u2: Optional[torch.Tensor] = None,
                        v2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ETHER+ absorption H⁺·W (·H̃⁺ with u2/v2), the left result rounded
    to W's dtype before the right pass, as ``ops.etherplus_merge`` runs
    the two kernels."""
    out = ref_etherplus_merge_left(w, u1, v1)
    return out if u2 is None else ref_etherplus_merge_right(out, u2, v2)


def norm_chain(u: torch.Tensor, ghat: torch.Tensor) -> torch.Tensor:
    """Pull dL/dû back through û = u/(‖u‖+ε) on the last axis (f32):
    du = ĝ/s − (u·ĝ) u/(r s²), r = ‖u‖, s = r + ε — exactly what AD of
    :func:`unit` gives (JAX: ``repro.kernels.reflect_bwd.norm_chain``)."""
    r = torch.sqrt((u * u).sum(dim=-1, keepdim=True))
    s = r + EPS
    dot = (u * ghat).sum(dim=-1, keepdim=True)
    return ghat / s - dot * u / (r * s * s)


def _reflect_bwd_f32(xb: torch.Tensor, gb: torch.Tensor, dirs):
    """The backward of y = x + Σ c û(ûᵀx) over the (û, c) in ``dirs``
    under cotangent g, blockwise, float32 (the JAX package's
    ``reflect_bwd_tile`` per direction).  xb, gb: (T, n, db).  Returns
    dx (T, n, db) and ĝ = c Σ_t [(ûᵀx_t) g_t + (ûᵀg_t) x_t] per direction."""
    dx, ghats = gb, []
    for uh, c in dirs:
        pg = torch.einsum("tnb,nb->tn", gb, uh)
        px = torch.einsum("tnb,nb->tn", xb, uh)
        dx = dx + c * pg[..., None] * uh
        ghats.append(c * (torch.einsum("tn,tnb->nb", px, gb)
                          + torch.einsum("tn,tnb->nb", pg, xb)))
    return dx, ghats


def _dirs(u: torch.Tensor, v: Optional[torch.Tensor]):
    """(û, c) of the rank-1 reflection (c = −2), or of ETHER+'s rank-2
    update (−1 for û, +1 for v̂) when v is given."""
    if v is None:
        return [(unit(u.float()), -2.0)]
    return [(unit(u.float()), -1.0), (unit(v.float()), 1.0)]


def ref_reflect_gemm_dx(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                        g: torch.Tensor, v: Optional[torch.Tensor] = None):
    """(dx, du) of y = R(x) @ w under cotangent g, in float32: dXr = g·wᵀ,
    dx = R(dXr) in x's dtype, du = norm_chain(u, ĝ) in u's dtype.  R is
    the reflection (ĝ = −2 Σ_t [(ûᵀx_t) dXr_t + (ûᵀdXr_t) x_t]), or with
    v ETHER+'s H⁺, and then (dx, du, dv) with coefficients −1 and +1.
    x: (T, d); w: (d, f); u, v: (n, db); g: (T, f)."""
    n, db = u.shape
    t = x.shape[0]
    dxr = (g.float() @ w.float().T).reshape(t, n, db)
    dx, ghats = _reflect_bwd_f32(x.float().reshape(t, n, db), dxr,
                                 _dirs(u, v))
    grads = [norm_chain(a.float(), gh).to(a.dtype)
             for a, gh in zip((u, v), ghats)]
    return (dx.reshape(x.shape).to(x.dtype), *grads)


def ref_reflect_gemm_dw(x: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                        w_dtype: torch.dtype,
                        v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW = R(x)ᵀ @ g in float32 (R = H⁺ when v is given), rounded once
    to ``w_dtype``.  x: (T, d); u, v: (n, db); g: (T, f)."""
    xr = _reflect_f32(x, u) if v is None else _rank2_f32(x, u, v)
    return (xr.T @ g.float()).to(w_dtype)


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


def ref_etherplus_reflect_bwd(x: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor):
    """(dx, du, dv) of y = H⁺x under cotangent g (``_r2_bwd_kernel``):
    dx = H⁺g in x's dtype, du/dv through the norm chain in u's/v's dtype.
    x, g: (T, d); u, v: (n, db)."""
    n, db = u.shape
    t = x.shape[0]
    dx, (gu, gv) = _reflect_bwd_f32(x.float().reshape(t, n, db),
                                    g.float().reshape(t, n, db),
                                    _dirs(u, v))
    return (dx.reshape(x.shape).to(x.dtype),
            norm_chain(u.float(), gu).to(u.dtype),
            norm_chain(v.float(), gv).to(v.dtype))


def ref_ether_reflect_bwd(x: torch.Tensor, u: torch.Tensor,
                          g: torch.Tensor):
    """(dx, du) of y = H_B x under cotangent g (``_r1_bwd_kernel``): dx =
    g − 2(ûᵀg)û in x's dtype, du through the norm chain in u's dtype, in
    float32 inside.  x, g: (..., d); u: (n, db)."""
    n, db = u.shape
    dx, (gu,) = _reflect_bwd_f32(x.float().reshape(-1, n, db),
                                 g.float().reshape(-1, n, db), _dirs(u, None))
    return (dx.reshape(x.shape).to(x.dtype),
            norm_chain(u.float(), gu).to(u.dtype))


def ref_etherplus_gemm_bwd(x: torch.Tensor, w: torch.Tensor, u1: torch.Tensor,
                           v1: torch.Tensor, u2: Optional[torch.Tensor],
                           v2: Optional[torch.Tensor], g: torch.Tensor, *,
                           need_dw: bool = True):
    """(dx, dw, du1, dv1, du2, dv2) of :func:`ref_etherplus_gemm` under
    cotangent g, composed as the JAX package's ``ops.etherplus_gemm_bwd``:
    two-sided adapters recompute y0 = (H⁺x)·W in the activation dtype,
    take dy0, du2, dv2 from the rank-2 reflection backward on it (dy0 in
    the activation dtype), then dx, du1, dv1 (and dW) from the rank-2
    reflect-GEMM backward under dy0.  du2/dv2 are None one-sided, dw
    unless ``need_dw``.  x: (..., d); g: (..., f)."""
    d, f = w.shape
    x2, g2 = x.reshape(-1, d), g.reshape(-1, f)
    if u2 is None:
        dy0, du2, dv2 = g2, None, None
    else:
        y0 = ref_etherplus_gemm(x2, w, u1, v1)
        dy0, du2, dv2 = ref_etherplus_reflect_bwd(y0, u2, v2, g2)
    dx, du1, dv1 = ref_reflect_gemm_dx(x2, w, u1, dy0, v1)
    dw = ref_reflect_gemm_dw(x2, u1, dy0, w.dtype, v1) if need_dw else None
    return dx.reshape(x.shape), dw, du1, dv1, du2, dv2


# ---------------------------------------------------------------------------
# The merges' backwards (weight-mode training)
# ---------------------------------------------------------------------------

def ref_merge_left_bwd(w: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                       v: Optional[torch.Tensor] = None, *,
                       need_dw: bool = True):
    """(dw, du[, dv]) of W' = H·W (H⁺·W with v) on the input dim under
    cotangent g, by the kernel's formula in float32 (``merge_left_bwd``):
    per block i, dW_i = G_i + c û(ûᵀG_i) and ĝ = c [G_i(W_iᵀû) +
    W_i(G_iᵀû)] over the directions (û, c = −2; with v, û with −1 and v̂
    with +1), which is the reflection backward of the columns of W.  dw in
    w's dtype (None unless ``need_dw``), du/dv through the norm chain in
    u's/v's dtype.  w, g: (d, f); u, v: (n, db), n·db = d."""
    n, db = u.shape
    d, f = w.shape
    dwt, ghats = _reflect_bwd_f32(w.float().T.reshape(f, n, db),
                                  g.float().T.reshape(f, n, db), _dirs(u, v))
    dw = dwt.reshape(f, d).T.contiguous().to(w.dtype) if need_dw else None
    grads = [norm_chain(a.float(), gh).to(a.dtype)
             for a, gh in zip((u, v), ghats)]
    return (dw, *grads)


def ref_ether_merge_bwd(w: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                        *, need_dw: bool = True):
    """(dw, du) of :func:`ref_ether_merge` under cotangent g (d, f): the
    rank-1 left merge backward; dw None unless ``need_dw``."""
    return ref_merge_left_bwd(w, u, g, need_dw=need_dw)


def ref_etherplus_merge_bwd(w: torch.Tensor, u1: torch.Tensor,
                            v1: torch.Tensor, u2: Optional[torch.Tensor],
                            v2: Optional[torch.Tensor], g: torch.Tensor, *,
                            need_dw: bool = True):
    """(dw, du1, dv1, du2, dv2) of :func:`ref_etherplus_merge` under
    cotangent g (d, f), composed as the JAX package's
    ``ops.etherplus_merge_bwd``: one-sided, the rank-2 left backward;
    two-sided, w1 = H⁺·w rounded to w's dtype, the right backward on
    (w1, g) gives dw1 in w's dtype (rounded, as the Pallas kernel writes
    it), then the left backward on (w, dw1).  du2/dv2 are None
    one-sided; dw None unless ``need_dw`` (the right pass always gives
    dw1)."""
    if u2 is None:
        dw, du1, dv1 = ref_merge_left_bwd(w, u1, g, v1, need_dw=need_dw)
        return dw, du1, dv1, None, None
    w1 = ref_etherplus_merge_left(w, u1, v1)
    # W·H̃⁺ updates each row of W: the right backward (the plain version
    # of ``merge_right_bwd``) is the rank-2 reflection backward of W's rows
    dw1, du2, dv2 = ref_etherplus_reflect_bwd(w1, u2, v2, g)
    dw, du1, dv1 = ref_merge_left_bwd(w, u1, dw1, v1, need_dw=need_dw)
    return dw, du1, dv1, du2, dv2


# ---------------------------------------------------------------------------
# DeLoRA and HyperAdapt
# ---------------------------------------------------------------------------

def ref_delora_gemm(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """y = xW + ((x a)·s) b in float32, rounded once, as
    ``_delora_kernel`` computes it.  x: (..., d); w: (d, f); a: (d, r);
    b: (r, f); s: (r,)."""
    xf = x.float()
    h = (xf @ a.float()) * s.float()
    return (xf @ w.float() + h @ b.float()).to(x.dtype)


def ref_hyperadapt_gemm(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
                        c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = ((x·r) W)·c in float32, rounded once, as ``_ha_kernel``
    computes it; without c the column scale is left out (the backward's
    z and y0).  x: (..., d); w: (d, f); r: (d,); c: (f,)."""
    y = (x.float() * r.float()) @ w.float()
    return (y if c is None else y * c.float()).to(x.dtype)


def ref_delora_merge(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """W' = W + (a·s) b in float32, rounded once to W's dtype.  w: (d, f)."""
    return (w.float() + (a.float() * s.float()) @ b.float()).to(w.dtype)


def ref_hyperadapt_merge(w: torch.Tensor, r: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """W' = diag(r) W diag(c) in float32, rounded once.  w: (d, f)."""
    return (w.float() * r.float()[:, None] * c.float()[None, :]).to(w.dtype)


def _plain_dw(x: torch.Tensor, g: torch.Tensor,
              w_dtype: torch.dtype) -> torch.Tensor:
    """xᵀ g in float32, rounded once: the reflection dW with a zero
    hyperplane, as the JAX package's ``ops._plain_dw`` runs it."""
    return (x.float().T @ g.float()).to(w_dtype)


def ref_delora_gemm_bwd(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, s: torch.Tensor, g: torch.Tensor, *,
                        need_dw: bool = True):
    """(dx, dw, da, db, ds) of :func:`ref_delora_gemm` under cotangent g,
    composed as the JAX package's ``ops.delora_gemm_bwd``: dx is the
    forward on transposed operands, g Wᵀ + ((g bᵀ)·s) aᵀ, rounded to the
    activation dtype; dW = xᵀg; da, db, ds are rank-r contractions in
    float32 over h = x a and p = g bᵀ.  dw is None unless ``need_dw``.
    x: (..., d); g: (..., f)."""
    d, f = w.shape
    x2, g2 = x.reshape(-1, d), g.reshape(-1, f)
    dx = ref_delora_gemm(g2, w.T, b.T, a.T, s).to(x.dtype)
    dw = _plain_dw(x2, g2, w.dtype) if need_dw else None
    xf, gf, sf = x2.float(), g2.float(), s.float()
    h = xf @ a.float()
    p = gf @ b.float().T
    return (dx.reshape(x.shape), dw, (xf.T @ (p * sf)).to(a.dtype),
            ((h * sf).T @ gf).to(b.dtype), (h * p).sum(dim=0).to(s.dtype))


def ref_hyperadapt_gemm_bwd(x: torch.Tensor, w: torch.Tensor,
                            r: torch.Tensor, c: torch.Tensor,
                            g: torch.Tensor, *, need_dw: bool = True):
    """(dx, dw, dr, dc) of :func:`ref_hyperadapt_gemm` under cotangent g,
    composed as the JAX package's ``ops.hyperadapt_gemm_bwd``: z = (g·c)
    Wᵀ and y0 = (x·r) W are the forward without its column scale (W
    transposed for z), each rounded to the activation dtype; dx = z·r,
    dr = Σ x⊙z, dc = Σ y0⊙g; dW = (x·r)ᵀ(g·c) on operands rounded to the
    activation dtype.  dw is None unless ``need_dw``.  x: (..., d);
    g: (..., f)."""
    d, f = w.shape
    x2, g2 = x.reshape(-1, d), g.reshape(-1, f)
    z = ref_hyperadapt_gemm(g2, w.T, c)
    y0 = ref_hyperadapt_gemm(x2, w, r)
    xf, gf, zf = x2.float(), g2.float(), z.float()
    rf, cf = r.float(), c.float()
    dw = (_plain_dw((xf * rf).to(x.dtype), (gf * cf).to(g.dtype), w.dtype)
          if need_dw else None)
    return ((zf * rf).to(x.dtype).reshape(x.shape), dw,
            (xf * zf).sum(dim=0).to(r.dtype),
            (y0.float() * gf).sum(dim=0).to(c.dtype))


def ref_delora_merge_bwd(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         s: torch.Tensor, g: torch.Tensor, *,
                         need_dw: bool = True):
    """(dw, da, db, ds) of :func:`ref_delora_merge` under cotangent g
    (the JAX package's ``ops.delora_merge_bwd``): dw = g (None unless
    ``need_dw``), the rest rank-r contractions in float32."""
    gf, af, sf = g.float(), a.float(), s.float()
    gb = gf @ b.float().T
    return (g.to(w.dtype) if need_dw else None, (gb * sf).to(a.dtype),
            ((af * sf).T @ gf).to(b.dtype), (af * gb).sum(dim=0).to(s.dtype))


def ref_hyperadapt_merge_bwd(w: torch.Tensor, r: torch.Tensor,
                             c: torch.Tensor, g: torch.Tensor, *,
                             need_dw: bool = True):
    """(dw, dr, dc) of :func:`ref_hyperadapt_merge` under cotangent g (the
    JAX package's ``ops.hyperadapt_merge_bwd``): dw is the merge applied
    to g (None unless ``need_dw``); dr, dc single reductions of w⊙g in
    float32."""
    wg = w.float() * g.float()
    return (ref_hyperadapt_merge(g, r, c).to(w.dtype) if need_dw else None,
            (wg @ c.float()).to(r.dtype), (wg.T @ r.float()).to(c.dtype))


# ---------------------------------------------------------------------------
# Multi-tenant banks
# ---------------------------------------------------------------------------

def bank_index(ids: torch.Tensor, tenants: int) -> torch.Tensor:
    """The ids mapped into [0, tenants) as the JAX package's gather maps
    an index (and the kernels' row_tenant does): a negative id counts from
    the end, then the id is clamped.  int64, on the ids' device; no
    value is read on the host."""
    ids = ids.long()
    return torch.where(ids < 0, ids + tenants, ids).clamp(0, tenants - 1)


def gather(bank: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """bank[ids] along the tenant axis (first), ids mapped by
    :func:`bank_index`."""
    return bank[bank_index(ids, bank.shape[0])]


def scatter_add(shape, ids: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """Σ over the sequences b of seq[b] into row bank_index(ids)[b] of a
    float32 zeros of ``shape`` (tenant axis first): duplicate ids add.
    The transpose of :func:`gather`, so a sequence's cotangent lands on the
    tenant its forward read.  The JAX package's ``.at[ids].add`` instead
    drops an id ≥ A that its gather clamps (ROADMAP.md, Queue 3); the two
    agree on ids in [−A, A).  ``index_add_`` is deterministic on the card
    under ``torch.use_deterministic_algorithms(True)``."""
    out = torch.zeros(shape, dtype=torch.float32, device=seq.device)
    return out.index_add_(0, bank_index(ids, shape[0]), seq.float())


def bank_grad(bank: torch.Tensor, ids: torch.Tensor,
              ghat_seq: torch.Tensor) -> torch.Tensor:
    """A hyperplane bank's cotangent from per-sequence dL/dû (B, n, db):
    scatter-add over the ids, then the ε-norm chain per bank row (linear
    in dL/dû, so add-then-chain is chain-then-add), in the bank's dtype:
    the JAX package's ``ops._bank_grad``.  A tenant no id names gets an
    exact zero, as the kernels' bank_chain_kernel writes it."""
    gsum = scatter_add(bank.shape, ids, ghat_seq)
    hits = scatter_add(bank.shape[:1], ids, torch.ones(
        ghat_seq.shape[:1], device=ghat_seq.device))
    du = norm_chain(bank.float(), gsum)
    return torch.where((hits > 0).reshape(-1, *[1] * (bank.dim() - 1)), du,
                       torch.zeros_like(du)).to(bank.dtype)


def _rank2_bank_f32(x: torch.Tensor, u_bank: torch.Tensor,
                    v_bank: Optional[torch.Tensor],
                    ids: torch.Tensor) -> torch.Tensor:
    """Each sequence's blockwise update in float32: the reflection
    x − 2û(ûᵀx) without v_bank, ETHER+'s x − û(ûᵀx) + v̂(v̂ᵀx) with it.
    x: (B, S, d); banks (A, n, db), n·db = d."""
    b, s, d = x.shape
    _, n, db = u_bank.shape
    xb = x.float().reshape(b, s, n, db)
    uh = unit(gather(u_bank, ids).float())                   # (B, n, db)
    pu = torch.einsum("bsnd,bnd->bsn", xb, uh)
    if v_bank is None:
        return (xb - 2.0 * pu[..., None] * uh[:, None]).reshape(b, s, d)
    vh = unit(gather(v_bank, ids).float())
    pv = torch.einsum("bsnd,bnd->bsn", xb, vh)
    return (xb - pu[..., None] * uh[:, None]
            + pv[..., None] * vh[:, None]).reshape(b, s, d)


def ref_ether_reflect_batched(x: torch.Tensor, u_bank: torch.Tensor,
                              ids: torch.Tensor) -> torch.Tensor:
    """R_{ids[b]} x[b] in float32, rounded once: each sequence's
    hyperplanes gathered first, then normalised, then the reflection (the
    JAX package's order, ``repro.kernels.ref.ref_ether_reflect_batched``).
    x: (B, S, d); u_bank: (A, n, db); ids: (B,)."""
    return _rank2_bank_f32(x, u_bank, None, ids).to(x.dtype)


def ref_householder_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                                 u_bank: torch.Tensor,
                                 ids: torch.Tensor) -> torch.Tensor:
    """y[b] = R_{ids[b]}(x[b]) @ W in float32, rounded once.  x: (B, S, d);
    w: (d, f); u_bank: (A, n, db); ids: (B,)."""
    return (_rank2_bank_f32(x, u_bank, None, ids) @ w.float()).to(x.dtype)


def ref_etherplus_reflect_batched(x: torch.Tensor, u_bank: torch.Tensor,
                                  v_bank: torch.Tensor,
                                  ids: torch.Tensor) -> torch.Tensor:
    """H⁺_{ids[b]} x[b] in float32, rounded once.  x: (B, S, d);
    u_bank/v_bank: (A, n, db); ids: (B,)."""
    return _rank2_bank_f32(x, u_bank, v_bank, ids).to(x.dtype)


def ref_delora_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                            a_bank: torch.Tensor, b_bank: torch.Tensor,
                            s_bank: torch.Tensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """y[b] = x[b]W + ((x[b] a_t)·s_t) b_t, t = ids[b], in float32,
    rounded once.  x: (B, S, d); a_bank: (A, d, r); b_bank: (A, r, f);
    s_bank: (A, r); ids: (B,)."""
    xf = x.float()
    h = torch.einsum("bsd,bdr->bsr", xf, gather(a_bank, ids).float())
    h = h * gather(s_bank, ids).float()[:, None, :]
    return (xf @ w.float() + torch.einsum(
        "bsr,brf->bsf", h, gather(b_bank, ids).float())).to(x.dtype)


def ref_hyperadapt_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                                r_bank: torch.Tensor,
                                c_bank: Optional[torch.Tensor],
                                ids: torch.Tensor) -> torch.Tensor:
    """y[b] = ((x[b]·r_t) W)·c_t, t = ids[b], in float32, rounded once;
    without c_bank the column scale is left out (the backward's z and
    y0).  x: (B, S, d); r_bank: (A, d); c_bank: (A, f); ids: (B,)."""
    r = gather(r_bank, ids).float()[:, None, :]
    y = (x.float() * r) @ w.float()
    if c_bank is not None:
        y = y * gather(c_bank, ids).float()[:, None, :]
    return y.to(x.dtype)


def _bank_reflect_bwd_f32(x: torch.Tensor, gd: torch.Tensor,
                          u_bank: torch.Tensor, v_bank: Optional[torch.Tensor],
                          ids: torch.Tensor):
    """Each sequence's reflection backward (ETHER+'s rank 2 with v_bank)
    under its own tenant's hyperplanes, float32: dx (B, S, d) and the
    per-sequence un-normalised dL/dû (and dL/dv̂), (B, n, db) each — the
    Pallas bank kernels' outputs.  x: (B, S, d); gd: (B, S, d) the
    cotangent of the update's output."""
    b, s, d = x.shape
    _, n, db = u_bank.shape
    xb = x.float().reshape(b, s, n, db)
    gb = gd.float().reshape(b, s, n, db)
    dirs = ([(unit(gather(u_bank, ids).float()), -2.0)] if v_bank is None
            else [(unit(gather(u_bank, ids).float()), -1.0),
                  (unit(gather(v_bank, ids).float()), 1.0)])
    dx, ghats = gb, []
    for uh, c in dirs:
        pg = torch.einsum("bsnd,bnd->bsn", gb, uh)
        px = torch.einsum("bsnd,bnd->bsn", xb, uh)
        dx = dx + c * pg[..., None] * uh[:, None]
        ghats.append(c * (torch.einsum("bsn,bsnd->bnd", px, gb)
                          + torch.einsum("bsn,bsnd->bnd", pg, xb)))
    return dx.reshape(b, s, d), ghats


def ref_householder_gemm_batched_bwd(x: torch.Tensor, w: torch.Tensor,
                                     u_bank: torch.Tensor, ids: torch.Tensor,
                                     g: torch.Tensor):
    """(dx, ĝ_seq) of :func:`ref_householder_gemm_batched` under cotangent
    g (B, S, f), the split outputs of ``householder_gemm_batched_bwd_pallas``:
    dXr = g·Wᵀ in float32, dx = R_t(dXr) in x's dtype, ĝ_seq (B, n, db)
    float32 the per-sequence dL/dû that :func:`bank_grad` finishes."""
    dxr = g.float() @ w.float().T
    dx, (gh,) = _bank_reflect_bwd_f32(x, dxr, u_bank, None, ids)
    return dx.to(x.dtype), gh


def ref_householder_gemm_batched_dw(x: torch.Tensor, u_bank: torch.Tensor,
                                    ids: torch.Tensor, g: torch.Tensor,
                                    w_dtype: torch.dtype) -> torch.Tensor:
    """dW = Σ_b R_{ids[b]}(x[b])ᵀ g[b] in float32, rounded once to
    ``w_dtype``.  x: (B, S, d); g: (B, S, f)."""
    xr = _rank2_bank_f32(x, u_bank, None, ids)
    return (xr.reshape(-1, x.shape[-1]).T
            @ g.float().reshape(-1, g.shape[-1])).to(w_dtype)


def ref_etherplus_reflect_batched_bwd(x: torch.Tensor, u_bank: torch.Tensor,
                                      v_bank: torch.Tensor, ids: torch.Tensor,
                                      g: torch.Tensor):
    """(dx, ĝu_seq, ĝv_seq) of :func:`ref_etherplus_reflect_batched` under
    cotangent g (B, S, d), the outputs of
    ``etherplus_reflect_batched_bwd_pallas``: dx = H⁺_t g in x's dtype,
    the per-sequence dL/dû and dL/dv̂ (B, n, db) float32."""
    dx, (gu, gv) = _bank_reflect_bwd_f32(x, g, u_bank, v_bank, ids)
    return dx.to(x.dtype), gu, gv


def ref_householder_gemm_batched_grads(x: torch.Tensor, w: torch.Tensor,
                                       u_bank: torch.Tensor,
                                       ids: torch.Tensor, g: torch.Tensor, *,
                                       need_dw: bool = True):
    """(dx, dw, du_bank) of :func:`ref_householder_gemm_batched` under
    cotangent g, as the JAX package's ``ops.householder_gemm_batched_bwd``
    finishes its kernels' outputs: ĝ_seq through :func:`bank_grad`; dw
    None unless ``need_dw``."""
    dx, gh = ref_householder_gemm_batched_bwd(x, w, u_bank, ids, g)
    dw = (ref_householder_gemm_batched_dw(x, u_bank, ids, g, w.dtype)
          if need_dw else None)
    return dx, dw, bank_grad(u_bank, ids, gh)


def ref_etherplus_reflect_batched_grads(x: torch.Tensor, u_bank: torch.Tensor,
                                        v_bank: torch.Tensor,
                                        ids: torch.Tensor, g: torch.Tensor):
    """(dx, du_bank, dv_bank) of :func:`ref_etherplus_reflect_batched`
    under cotangent g: the per-sequence ĝ through :func:`bank_grad`, as
    the JAX package's ``ops.etherplus_reflect_batched_bwd``."""
    dx, gu, gv = ref_etherplus_reflect_batched_bwd(x, u_bank, v_bank, ids, g)
    return dx, bank_grad(u_bank, ids, gu), bank_grad(v_bank, ids, gv)


def ref_ether_reflect_batched_bwd(x: torch.Tensor, u_bank: torch.Tensor,
                                  ids: torch.Tensor, g: torch.Tensor):
    """(dx, du_bank) of :func:`ref_ether_reflect_batched` under cotangent g
    (B, S, d), in float32 inside: dx = R_t g in x's dtype, and the
    per-sequence dL/dû (``ether_reflect_batched_bwd_pallas``'s second
    output) through :func:`bank_grad`, as the JAX package's
    ``ops.ether_reflect_batched_bwd`` finishes it."""
    dx, (gu,) = _bank_reflect_bwd_f32(x, g, u_bank, None, ids)
    return dx.to(x.dtype), bank_grad(u_bank, ids, gu)


def delora_bank_cotangents(x: torch.Tensor, g: torch.Tensor,
                           a_bank: torch.Tensor, b_bank: torch.Tensor,
                           s_bank: torch.Tensor, ids: torch.Tensor):
    """(da_bank, db_bank, ds_bank) of the bank DeLoRA GEMM under g (B, S,
    f): per-sequence rank-r contractions over h = x a_t and p = g b_tᵀ in
    float32, scatter-added over the ids (:func:`scatter_add`) and cast to
    each bank's dtype — the JAX package's jnp glue beside its kernels."""
    xf, gf = x.float(), g.float()
    sf = gather(s_bank, ids).float()[:, None, :]              # (B, 1, r)
    h = torch.einsum("bsd,bdr->bsr", xf, gather(a_bank, ids).float())
    p = torch.einsum("bsf,brf->bsr", gf, gather(b_bank, ids).float())
    return (scatter_add(a_bank.shape, ids,
                        torch.einsum("bsd,bsr->bdr", xf, p * sf))
            .to(a_bank.dtype),
            scatter_add(b_bank.shape, ids,
                        torch.einsum("bsr,bsf->brf", h * sf, gf))
            .to(b_bank.dtype),
            scatter_add(s_bank.shape, ids, (h * p).sum(dim=1))
            .to(s_bank.dtype))


def hyperadapt_bank_cotangents(x: torch.Tensor, g: torch.Tensor,
                               z: torch.Tensor, y0: torch.Tensor,
                               r_bank: torch.Tensor, c_bank: torch.Tensor,
                               ids: torch.Tensor):
    """(dx, dr_bank, dc_bank) of the bank HyperAdapt GEMM from its
    recomputed z = (g·c_t) Wᵀ and y0 = (x·r_t) W: dx = z·r_t in x's dtype,
    the per-sequence sums Σ x⊙z and Σ y0⊙g scatter-added over the ids, in
    float32 cast to each bank's dtype — the JAX package's jnp glue."""
    rs = gather(r_bank, ids).float()[:, None, :]              # (B, 1, d)
    zf = z.float()
    return ((zf * rs).to(x.dtype),
            scatter_add(r_bank.shape, ids, (x.float() * zf).sum(dim=1))
            .to(r_bank.dtype),
            scatter_add(c_bank.shape, ids, (y0.float() * g.float())
                        .sum(dim=1)).to(c_bank.dtype))


def ref_delora_gemm_batched_bwd(x: torch.Tensor, w: torch.Tensor,
                                a_bank: torch.Tensor, b_bank: torch.Tensor,
                                s_bank: torch.Tensor, ids: torch.Tensor,
                                g: torch.Tensor, *, need_dw: bool = True):
    """(dx, dw, da_bank, db_bank, ds_bank) of
    :func:`ref_delora_gemm_batched` under cotangent g (B, S, f), composed
    as the JAX package's ``ops.delora_gemm_batched_bwd``: dx is the bank
    forward on transposed operands, g Wᵀ + ((g b_tᵀ)·s_t) a_tᵀ, rounded
    once; dW = xᵀg (None unless ``need_dw``); the adapters' cotangents are
    per-sequence rank-r contractions in float32, scatter-added over the
    ids (:func:`scatter_add`) and cast to each bank's dtype."""
    d = x.shape[-1]
    dx = ref_delora_gemm_batched(g, w.T, b_bank.transpose(1, 2),
                                 a_bank.transpose(1, 2), s_bank, ids)
    dw = (_plain_dw(x.reshape(-1, d), g.reshape(-1, g.shape[-1]), w.dtype)
          if need_dw else None)
    return (dx, dw, *delora_bank_cotangents(x, g, a_bank, b_bank, s_bank,
                                            ids))


def ref_hyperadapt_gemm_batched_bwd(x: torch.Tensor, w: torch.Tensor,
                                    r_bank: torch.Tensor, c_bank: torch.Tensor,
                                    ids: torch.Tensor, g: torch.Tensor, *,
                                    need_dw: bool = True):
    """(dx, dw, dr_bank, dc_bank) of :func:`ref_hyperadapt_gemm_batched`
    under cotangent g (B, S, f), composed as the JAX package's
    ``ops.hyperadapt_gemm_batched_bwd``: z = (g·c_t) Wᵀ and y0 = (x·r_t) W
    are the bank forward without its column scale (W transposed for z),
    each in float32 rounded once to the activation dtype (the JAX package
    rounds g·c_t and x·r_t first); dx = z·r_t; dr, dc are per-sequence
    sums Σ x⊙z and Σ y0⊙g scatter-added over the ids; dW = (x·r)ᵀ(g·c)
    on operands rounded to the activation dtype, None unless ``need_dw``."""
    z = ref_hyperadapt_gemm_batched(g, w.T, c_bank, None, ids)
    y0 = ref_hyperadapt_gemm_batched(x, w, r_bank, None, ids)
    dw = (_plain_dw(*hyperadapt_bank_scaled(x, g, r_bank, c_bank, ids),
                    w.dtype) if need_dw else None)
    dx, dr, dc = hyperadapt_bank_cotangents(x, g, z, y0, r_bank, c_bank, ids)
    return dx, dw, dr, dc


def hyperadapt_bank_scaled(x, g, r_bank, c_bank, ids):
    """(x·r_t, g·c_t) flattened to (B·S, ·) rows, each in float32 rounded
    to its own dtype: the dW operands of the bank HyperAdapt GEMM, as the
    JAX package's ``ops.hyperadapt_gemm_batched_bwd`` forms them."""
    rs = gather(r_bank, ids).float()[:, None, :]
    cs = gather(c_bank, ids).float()[:, None, :]
    return ((x.float() * rs).to(x.dtype).reshape(-1, x.shape[-1]),
            (g.float() * cs).to(g.dtype).reshape(-1, g.shape[-1]))


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality): the chunk scan's plain versions
# ---------------------------------------------------------------------------

def ref_ssd_chunk_scan(xv: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, chunk: Optional[int] = None):
    """The SSD recurrence step by step, O(S·N): the oracle of the chunked
    forms (the JAX package's ``ref.ref_ssd_chunk_scan``; ``chunk`` is
    unused there too).  xv: (B, S, H, P) inputs; a: (B, S, H) log-decay;
    b, c: (B, S, G, N) with H % G == 0, head h reading group h // (H/G).
    state_t = exp(a_t)·state_{t−1} + b_t ⊗ x_t, y_t = c_t · state_t, from
    a zero state, in float32; returns y (B, S, H, P) in xv's dtype."""
    B, S, H, P = xv.shape
    rep = H // b.shape[2]
    bh = b.float().repeat_interleave(rep, dim=2)             # (B, S, H, N)
    ch = c.float().repeat_interleave(rep, dim=2)
    state = xv.new_zeros((B, H, b.shape[3], P), dtype=torch.float32)
    ys = []
    for t in range(S):
        state = (torch.exp(a[:, t].float())[..., None, None] * state
                 + bh[:, t, :, :, None] * xv[:, t].float()[:, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    return torch.stack(ys, dim=1).to(xv.dtype)


def ref_ssd_chunk(xv: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int):
    """The intra-chunk SSD dual form of ``ssd_chunk_pallas``
    (src/repro/kernels/ssd_scan.py:52), for every (batch, head, chunk) of
    L = ``chunk`` steps: cum = cumsum(a) within the chunk,
    y_intra[i] = Σ_{j≤i} exp(cum_i − cum_j)·(c_i·b_j)·x_j,
    state = Σ_j exp(cum_L − cum_j)·b_j ⊗ x_j and decay = exp(cum_L), all
    in float32.  xv: (B, S, H, P); a: (B, S, H); b, c: (B, S, G, N),
    head h reading group h // (H/G); S % chunk == 0.  The Pallas
    kernel's (BH, S, P) operands with head-expanded b, c are the case
    H = G = 1.  Returns (y_intra (B, S, H, P), states (B, H, nc, N, P),
    decays (B, H, nc)), float32."""
    B, S, H, P = xv.shape
    G, N = b.shape[2], b.shape[3]
    L, nc = chunk, S // chunk
    x = xv.float().reshape(B, nc, L, H, P)
    cum = a.float().reshape(B, nc, L, H).cumsum(dim=2)
    ct = cum.transpose(2, 3)                                  # (B, nc, H, L)
    causal = torch.ones(L, L, dtype=torch.bool, device=xv.device).tril()
    # exp of a difference, ≤ 1 on and below the diagonal; 0 above it
    decay = torch.exp((ct[..., :, None] - ct[..., None, :])
                      .masked_fill(~causal, float("-inf")))
    bg = b.float().reshape(B, nc, L, G, N)
    cg = c.float().reshape(B, nc, L, G, N)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cg, bg)         # (B, nc, G, L, L)
    scores = decay.reshape(B, nc, G, H // G, L, L) * cb[:, :, :, None]
    y = torch.einsum("bchls,bcshp->bclhp",
                     scores.reshape(B, nc, H, L, L), x)
    w_in = torch.exp(cum[:, :, -1:] - cum)                    # (B, nc, L, H)
    bh = bg.repeat_interleave(H // G, dim=3)                  # (B, nc, L, H, N)
    states = torch.einsum("bclhn,bclh,bclhp->bhcnp", bh, w_in, x)
    decays = torch.exp(cum[:, :, -1]).transpose(1, 2)         # (B, H, nc)
    return y.reshape(B, S, H, P), states, decays.contiguous()


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        q_offset: Optional[int] = None,
                        q_chunk: Optional[int] = None) -> torch.Tensor:
    """Exact softmax attention, call for call the JAX package's
    ``ref_flash_attention`` (src/repro/kernels/ref.py:256): q (B, H, S, D)
    against k, v (B, Hkv, T, D), query head h on KV head h // (H/Hkv)
    (grouped, not repeated); f32 scores scaled by ``scale`` (default
    1/√D), masked where kpos > qpos (``causal``) or kpos ≤ qpos −
    ``window``, the masked probabilities zeroed as the Pallas kernel
    does, so a row with no valid key is exact zeros; one rounding to q's
    dtype.  Query row i sits at ``q_offset + i``; ``q_offset=None``
    places it at T − S + i, as the JAX ref does (the kernel's wrapper
    always passes its own q_offset).

    ``q_chunk`` rows of queries at a time bound the live scores to (B, H,
    q_chunk, T), as the JAX package's einsum ``attention_core`` does: the
    ``torch`` route of the models' attention, under autograd too."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    off = t - s if q_offset is None else q_offset
    if q_chunk is not None and s > q_chunk:
        return torch.cat([ref_flash_attention(
            q[:, :, i:i + q_chunk], k, v, causal=causal, window=window,
            scale=scale, q_offset=off + i) for i in range(0, s, q_chunk)],
            dim=2)
    scale = 1.0 / d ** 0.5 if scale is None else scale
    qpos = off + torch.arange(s, device=q.device)
    kpos = torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    qg = q.reshape(b, hkv, h // hkv, s, d)                # (B, G, R, S, D)
    logits = (qg.float() @ k.float()[:, :, None].transpose(-1, -2)) * scale
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p.masked_fill(~mask, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (p @ v.float()[:, :, None]).reshape(b, h, s, d).to(q.dtype)
