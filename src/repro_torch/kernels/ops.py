"""Public wrappers of the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity and raises
:class:`KernelInputError`, naming the shapes and dtypes it refuses, on
anything its kernel does not take.  On CUDA tensors it launches the
kernel and raises :class:`KernelLaunchError` if the launch is refused;
on CPU tensors, and only there, it computes the kernel's plain version.
There is no fallback from a CUDA tensor to the plain version.

``launches()`` counts launches per kernel (plain-version calls are not
launches; ``householder_gemm_bwd`` launches ``reflect_gemm_dx``, and
``reflect_gemm_dw`` only when asked for dW; ``etherplus_gemm_bwd``
launches those two with ETHER+'s second hyperplanes and, two-sided,
``etherplus_gemm`` and ``etherplus_reflect_bwd`` first;
``etherplus_merge`` launches ``etherplus_merge_left`` and, two-sided,
``etherplus_merge_right``; ``delora_gemm_bwd`` launches ``delora_gemm``
for dx and ``reflect_gemm_dw`` with a zero hyperplane only when asked for
dW; ``hyperadapt_gemm_bwd`` launches ``hyperadapt_gemm`` twice, for z and
y0, and ``reflect_gemm_dw`` likewise; ``hyperadapt_merge_bwd`` launches
``hyperadapt_merge`` only when asked for dW; ``etherplus_merge_bwd``
launches ``merge_left_bwd`` (rank 2) after, two-sided,
``etherplus_merge_left`` (w1) and ``merge_right_bwd``; each bank wrapper
launches its one kernel, which for ``householder_gemm_batched`` and
``delora_gemm_batched`` is a short pass and a GEMM), so a run can show
that its path went through the kernels.  The rank-r and per-feature
cotangents of DeLoRA and HyperAdapt are a few thin PyTorch ops beside the
kernels, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import batched as _bk
from repro_torch.kernels import delora_gemm as _dg
from repro_torch.kernels import ether_merge as _merge
from repro_torch.kernels import etherplus_gemm as _ep
from repro_torch.kernels import etherplus_merge as _epm
from repro_torch.kernels import etherplus_reflect_bwd as _rb
from repro_torch.kernels import householder_gemm as _hh
from repro_torch.kernels import hyperadapt_gemm as _hg
from repro_torch.kernels import merge_bwd as _mb
from repro_torch.kernels import method_merge as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import reflect_gemm_dw as _dw
from repro_torch.kernels import reflect_gemm_dx as _dx

_LAUNCHES = {"householder_gemm": 0, "ether_merge": 0, "reflect_gemm_dx": 0,
             "reflect_gemm_dw": 0, "etherplus_gemm": 0,
             "etherplus_merge_left": 0, "etherplus_merge_right": 0,
             "etherplus_reflect_bwd": 0, "delora_gemm": 0,
             "hyperadapt_gemm": 0, "delora_merge": 0, "hyperadapt_merge": 0,
             "householder_gemm_batched": 0, "etherplus_reflect_batched": 0,
             "delora_gemm_batched": 0, "hyperadapt_gemm_batched": 0,
             "merge_left_bwd": 0, "merge_right_bwd": 0}
_F32 = torch.float32
_ID_DTYPES = (torch.int32, torch.int64)


class KernelInputError(ValueError):
    """A wrapper refused its inputs (device, dtype, shape or layout)."""


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a kernel launch."""


def launches() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _refuse(op: str, main: torch.Tensor, main_d: int, **tensors) -> None:
    """Raise KernelInputError naming the first check the operands fail
    (run only once the wrapper's one-expression check has failed).  The
    ETHER+ operands are v (u's twin) and the output side's u2/v2; a None
    u2/v2 (one-sided) is left out of ``tensors`` by the caller."""
    w, u = tensors["w"], tensors["u"]
    if main.dtype not in _hh.DTYPE_CODE:
        why = "the kernel takes float32 or bfloat16 activations and weights"
    elif u.dtype != _F32 or u.dim() != 2:
        why = "u must be a float32 (n, db) tensor"
    elif w.dim() != 2 or w.dtype != main.dtype:
        why = "w must be a (d, f) matrix in the activations' dtype"
    elif not w.shape[0] == u.shape[0] * u.shape[1] == main_d:
        why = "need x (..., d), w (d, f) and u (n, db) with n·db = d"
    elif "v" in tensors and not _twin_ok(u, tensors["v"]):
        why = "v must be a float32 tensor of u's shape"
    elif ("u2" in tensors) != ("v2" in tensors) or "u2" in tensors and not (
            _side_ok(tensors["u2"], tensors["v2"], w.shape[1])):
        why = ("u2 and v2 must both be given, as float32 (n_out, db_out) "
               "tensors of one shape with n_out·db_out = f")
    elif "g" in tensors and not _g_ok(main, w, tensors["g"]):
        why = ("g must be (..., f) in the activations' dtype, with x's "
               "leading dims")
    elif len({t.device for t in tensors.values()}) != 1:
        why = "all operands must be on one device"
    elif main.device.type not in ("cpu", "cuda"):
        why = "operands must be on the CPU or a CUDA device"
    elif not all(t.is_contiguous() for t in tensors.values()):
        why = "operands must be contiguous"
    else:
        why = "operands must not be empty"
    desc = ", ".join(f"{k} {tuple(v.shape)} {v.dtype} on {v.device}"
                     for k, v in tensors.items())
    raise KernelInputError(f"{op} refuses {desc}: {why}")


def _ok(main: torch.Tensor, main_d: int, w: torch.Tensor,
        u: torch.Tensor) -> bool:
    """The wrappers' common check, as one expression for the hot path;
    ``main_d`` is the main operand's reflected dim."""
    dev = main.device
    return (main.dtype in _hh.DTYPE_CODE and w.dtype == main.dtype
            and u.dtype == _F32 and w.dim() == 2 and u.dim() == 2
            and w.shape[0] == u.shape[0] * u.shape[1] == main_d
            and w.device == dev and u.device == dev
            and dev.type in ("cpu", "cuda")
            and main.is_contiguous() and w.is_contiguous()
            and u.is_contiguous() and main.numel() > 0 and w.numel() > 0)


def _g_ok(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> bool:
    """The cotangent's dtype and shape: g (..., f) matches y."""
    return g.dtype == x.dtype and g.shape == (*x.shape[:-1], w.shape[1])


def _twin_ok(u: torch.Tensor, v: Optional[torch.Tensor]) -> bool:
    """ETHER+'s v beside an already checked u: same shape, dtype, device
    and layout."""
    return (v is not None and v.dtype == _F32 and v.shape == u.shape
            and v.device == u.device and v.is_contiguous())


def _side_ok(u2: Optional[torch.Tensor], v2: Optional[torch.Tensor],
             f: int) -> bool:
    """The output side's pair: both None (one-sided), or float32
    (n_out, db_out) twins with n_out·db_out = f."""
    if u2 is None or v2 is None:
        return u2 is None and v2 is None
    return (u2.dtype == _F32 and u2.dim() == 2 and u2.is_contiguous()
            and u2.shape[0] * u2.shape[1] == f and _twin_ok(u2, v2))


def _given(**tensors) -> dict:
    """The operands that are not None, for :func:`_refuse`."""
    return {k: t for k, t in tensors.items() if t is not None}


def _launched(op: str, err: int) -> None:
    if err:
        raise KernelLaunchError(
            f"{op}: CUDA refused the launch (cudaError_t {err})")
    _LAUNCHES[op] += 1


def householder_gemm(x: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """reflect(x) @ w; x: (..., d); w: (d, f); u: (n, db) f32, n·db = d.
    Leading dims of x are flattened into the kernel's row axis."""
    if not _ok(x, x.shape[-1] if x.dim() else -1, w, u):
        _refuse("householder_gemm", x, x.shape[-1] if x.dim() else -1,
                x=x, w=w, u=u)
    d, f = w.shape
    lead = x.shape[:-1]
    x2 = x.view(-1, d)
    if x.device.type == "cpu":
        return ref.ref_householder_gemm(x2, w, u).view(*lead, f)
    err, y = _hh.launch(x2, w, u)
    _launched("householder_gemm", err)
    return y.view(*lead, f)


def ether_merge(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """H_B w for adapter absorption; w: (d, f); u: (n, db) f32, n·db = d."""
    if not _ok(w, w.shape[0] if w.dim() else -1, w, u):
        _refuse("ether_merge", w, w.shape[0] if w.dim() else -1, w=w, u=u)
    if w.device.type == "cpu":
        return ref.ref_ether_merge(w, u)
    err, out = _merge.launch(w, u)
    _launched("ether_merge", err)
    return out


def householder_gemm_bwd(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                         g: torch.Tensor, *, need_dw: bool):
    """(dx, dw, du) of y = reflect(x) @ w under cotangent g (..., f);
    dw is None unless ``need_dw``, and its kernel then does not run.
    Leading dims of x and g are flattened into the kernels' row axis."""
    d = x.shape[-1] if x.dim() else -1
    if not (_ok(x, d, w, u) and _g_ok(x, w, g) and g.device == x.device
            and g.is_contiguous()):
        _refuse("householder_gemm_bwd", x, d, x=x, w=w, u=u, g=g)
    if x.device.type == "cpu":
        return ref.ref_householder_gemm_bwd(x, w, u, g, need_dw=need_dw)
    x2, g2 = x.view(-1, d), g.view(-1, w.shape[1])
    err, dx, du = _dx.launch(x2, w, u, g2)
    _launched("reflect_gemm_dx", err)
    dw = None
    if need_dw:
        err, dw = _dw.launch(x2, u, g2)
        _launched("reflect_gemm_dw", err)
    return dx.view(x.shape), dw, du


def etherplus_gemm(x: torch.Tensor, w: torch.Tensor, u1: torch.Tensor,
                   v1: torch.Tensor, u2: Optional[torch.Tensor] = None,
                   v2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(H⁺x) @ w, and with u2/v2 the two-sided H̃⁺ on the output blocks;
    x: (..., d); w: (d, f); u1/v1: (n, db) f32, n·db = d; u2/v2:
    (n_out, db_out) f32, n_out·db_out = f.  Leading dims of x are
    flattened into the kernel's row axis."""
    d = x.shape[-1] if x.dim() else -1
    if not (_ok(x, d, w, u1) and _twin_ok(u1, v1)
            and _side_ok(u2, v2, w.shape[1])
            and (u2 is None or u2.device == x.device)):
        _refuse("etherplus_gemm", x, d,
                **_given(x=x, w=w, u=u1, v=v1, u2=u2, v2=v2))
    f = w.shape[1]
    lead = x.shape[:-1]
    x2 = x.view(-1, d)
    if x.device.type == "cpu":
        return ref.ref_etherplus_gemm(x2, w, u1, v1, u2, v2).view(*lead, f)
    err, y = _ep.launch(x2, w, u1, v1, u2, v2)
    _launched("etherplus_gemm", err)
    return y.view(*lead, f)


def etherplus_merge(w: torch.Tensor, u1: torch.Tensor, v1: torch.Tensor,
                    u2: Optional[torch.Tensor] = None,
                    v2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ETHER+ absorption H⁺·w, then ·H̃⁺ with u2/v2, the left result
    rounded to w's dtype in between; w: (d, f); u1/v1: (n, db) f32 with
    n·db = d; u2/v2: (n_out, db_out) f32 with n_out·db_out = f."""
    d = w.shape[0] if w.dim() else -1
    if not (_ok(w, d, w, u1) and _twin_ok(u1, v1)
            and _side_ok(u2, v2, w.shape[1])
            and (u2 is None or u2.device == w.device)):
        _refuse("etherplus_merge", w, d,
                **_given(w=w, u=u1, v=v1, u2=u2, v2=v2))
    if w.device.type == "cpu":
        return ref.ref_etherplus_merge(w, u1, v1, u2, v2)
    err, out = _epm.launch_left(w, u1, v1)
    _launched("etherplus_merge_left", err)
    if u2 is not None:
        err, out = _epm.launch_right(out, u2, v2)
        _launched("etherplus_merge_right", err)
    return out


def etherplus_gemm_bwd(x: torch.Tensor, w: torch.Tensor, u1: torch.Tensor,
                       v1: torch.Tensor, u2: Optional[torch.Tensor],
                       v2: Optional[torch.Tensor], g: torch.Tensor, *,
                       need_dw: bool):
    """(dx, dw, du1, dv1, du2, dv2) of :func:`etherplus_gemm` under
    cotangent g (..., f), composed as the JAX package's
    ``ops.etherplus_gemm_bwd``: two-sided, y0 = (H⁺x)·W is recomputed by
    the one-sided forward kernel (in x's dtype) and
    ``etherplus_reflect_bwd`` gives dy0, du2, dv2; then the rank-2
    ``reflect_gemm_dx`` (and ``reflect_gemm_dw`` only when ``need_dw``)
    under dy0.  du2/dv2 are None one-sided, dw unless ``need_dw``."""
    d = x.shape[-1] if x.dim() else -1
    if not (_ok(x, d, w, u1) and _twin_ok(u1, v1)
            and _side_ok(u2, v2, w.shape[1])
            and (u2 is None or u2.device == x.device)
            and _g_ok(x, w, g) and g.device == x.device
            and g.is_contiguous()):
        _refuse("etherplus_gemm_bwd", x, d,
                **_given(x=x, w=w, u=u1, v=v1, u2=u2, v2=v2, g=g))
    if x.device.type == "cpu":
        return ref.ref_etherplus_gemm_bwd(x, w, u1, v1, u2, v2, g,
                                          need_dw=need_dw)
    x2, g2 = x.view(-1, d), g.view(-1, w.shape[1])
    if u2 is None:
        dy0, du2, dv2 = g2, None, None
    else:
        err, y0 = _ep.launch(x2, w, u1, v1)
        _launched("etherplus_gemm", err)
        err, dy0, du2, dv2 = _rb.launch(y0, u2, v2, g2)
        _launched("etherplus_reflect_bwd", err)
    err, dx, du1, dv1 = _dx.launch(x2, w, u1, dy0, v1)
    _launched("reflect_gemm_dx", err)
    dw = None
    if need_dw:
        err, dw = _dw.launch(x2, u1, dy0, v1)
        _launched("reflect_gemm_dw", err)
    return dx.view(x.shape), dw, du1, dv1, du2, dv2


# ---------------------------------------------------------------------------
# DeLoRA and HyperAdapt
# ---------------------------------------------------------------------------

def _dims(main: torch.Tensor, w: torch.Tensor) -> tuple[int, int]:
    """(d, f): the reduced dim of ``main`` (x (..., d), or w itself for a
    merge) and w's output dim, -1 where the shape has none."""
    lead = w if main is w else main
    d = (w.shape[0] if main is w else main.shape[-1]) if lead.dim() else -1
    return d, w.shape[1] if w.dim() == 2 else -1


def _check(op: str, main: torch.Tensor, w: torch.Tensor, side: dict,
           extra: Optional[str] = None) -> None:
    """The DeLoRA/HyperAdapt wrappers' check: ``main`` (x, or w itself for
    a merge) and w as for the reflections, each adapter operand of
    ``side`` (name → (tensor, shape, dtype)) of its shape and dtype,
    contiguous, on main's device, and no ``extra`` (a further condition
    the caller found false).  Raises KernelInputError naming the first
    check the operands fail."""
    d, _ = _dims(main, w)
    dev = main.device
    if extra is None and (
            main.dtype in _hh.DTYPE_CODE and w.dtype == main.dtype
            and w.dim() == 2 and w.shape[0] == d and w.device == dev
            and dev.type in ("cpu", "cuda") and main.is_contiguous()
            and w.is_contiguous() and main.numel() > 0 and w.numel() > 0
            and all(t.dtype == dt and t.shape == shape and t.device == dev
                    and t.is_contiguous() for t, shape, dt in side.values())):
        return
    named = {**({"w": w} if main is w else {"x": main, "w": w}),
             **{k: t for k, (t, _, _) in side.items()}}
    bad = [k for k, (t, shape, dt) in side.items()
           if t.dtype != dt or t.shape != shape]
    if main.dtype not in _hh.DTYPE_CODE:
        why = "the kernel takes float32 or bfloat16 activations and weights"
    elif w.dim() != 2 or w.dtype != main.dtype:
        why = "w must be a (d, f) matrix in the activations' dtype"
    elif w.shape[0] != d:
        why = "need x (..., d) and w (d, f)"
    elif bad:
        _, shape, dt = side[bad[0]]
        why = f"{bad[0]} must be {str(dt)[6:]} of shape {tuple(shape)}"
    elif len({t.device for t in named.values()}) != 1:
        why = "all operands must be on one device"
    elif dev.type not in ("cpu", "cuda"):
        why = "operands must be on the CPU or a CUDA device"
    elif not all(t.is_contiguous() for t in named.values()):
        why = "operands must be contiguous"
    else:
        why = extra or "operands must not be empty"
    desc = ", ".join(f"{k} {tuple(t.shape)} {t.dtype} on {t.device}"
                     for k, t in named.items())
    raise KernelInputError(f"{op} refuses {desc}: {why}")


def _delora_side(main, w, a, b, s, g=None) -> dict:
    """DeLoRA's operands for :func:`_check`: a (d, r), b (r, f) float32,
    s (r,) in main's dtype [, g (..., f) like y]."""
    d, f = _dims(main, w)
    r = a.shape[-1] if a.dim() == 2 else -1
    side = {"a": (a, (d, r), _F32), "b": (b, (r, f), _F32),
            "s": (s, (r,), main.dtype)}
    if g is not None:
        side["g"] = (g, (*main.shape[:-1], f), main.dtype)
    return side


def _hyperadapt_side(main, w, r, c, g=None) -> dict:
    """HyperAdapt's operands for :func:`_check`: r (d,), c (f,) float32
    [, g (..., f) like y]."""
    d, f = _dims(main, w)
    side = {"r": (r, (d,), _F32), "c": (c, (f,), _F32)}
    if g is not None:
        side["g"] = (g, (*main.shape[:-1], f), main.dtype)
    return side


def _rank_why(a: torch.Tensor) -> Optional[str]:
    """Why delora_gemm refuses a's rank, or None."""
    if a.dim() == 2 and 1 <= a.shape[1] <= _dg.MAX_RANK:
        return None
    return f"the kernel keeps h = x·a in shared memory: r ≤ {_dg.MAX_RANK}"


def _zero_u(d: int, device) -> torch.Tensor:
    """An all-zero hyperplane over all of d: û(0) = 0, so the reflection
    dW kernel computes the plain xᵀG (the JAX package's ``ops._zero_u``)."""
    return torch.zeros((1, d), dtype=_F32, device=device)


def delora_gemm(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x·w + ((x·a)·s)·b; x: (..., d); w: (d, f); a: (d, r) f32; b: (r, f)
    f32; s: (r,) in x's dtype, 1 ≤ r ≤ 512.  Leading dims of x are
    flattened into the kernel's row axis."""
    _check("delora_gemm", x, w, _delora_side(x, w, a, b, s), _rank_why(a))
    d, f = w.shape
    lead = x.shape[:-1]
    x2 = x.view(-1, d)
    if x.device.type == "cpu":
        return ref.ref_delora_gemm(x2, w, a, b, s).view(*lead, f)
    err, y = _dg.launch(x2, w, a, b, s)
    _launched("delora_gemm", err)
    return y.view(*lead, f)


def delora_merge(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """DeLoRA absorption w + (a·s)·b; w: (d, f); a: (d, r) f32; b: (r, f)
    f32; s: (r,) in w's dtype."""
    _check("delora_merge", w, w, _delora_side(w, w, a, b, s))
    if w.device.type == "cpu":
        return ref.ref_delora_merge(w, a, b, s)
    err, out = _mm.launch_delora(w, a, b, s)
    _launched("delora_merge", err)
    return out


def delora_gemm_bwd(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, s: torch.Tensor, g: torch.Tensor, *,
                    need_dw: bool):
    """(dx, dw, da, db, ds) of :func:`delora_gemm` under cotangent g
    (..., f), composed as the JAX package's ``ops.delora_gemm_bwd``: dx =
    g·wᵀ + ((g·bᵀ)·s)·aᵀ on the forward kernel with w read transposed in
    place (bᵀ, aᵀ are small copies); dW = xᵀg on ``reflect_gemm_dw`` with
    a zero hyperplane, only when ``need_dw`` (else None); da, db, ds
    rank-r contractions in float32."""
    _check("delora_gemm_bwd", x, w, _delora_side(x, w, a, b, s, g),
           _rank_why(a))
    if x.device.type == "cpu":
        return ref.ref_delora_gemm_bwd(x, w, a, b, s, g, need_dw=need_dw)
    d, f = w.shape
    x2, g2 = x.view(-1, d), g.view(-1, f)
    err, dx = _dg.launch(g2, w, b.T.contiguous(), a.T.contiguous(), s,
                         w_t=True)
    _launched("delora_gemm", err)
    dw = None
    if need_dw:
        err, dw = _dw.launch(x2, _zero_u(d, x.device), g2)
        _launched("reflect_gemm_dw", err)
    xf, gf, sf = x2.float(), g2.float(), s.float()
    h = xf @ a
    p = gf @ b.T
    return (dx.view(x.shape), dw, (xf.T @ (p * sf)),
            ((h * sf).T @ gf), (h * p).sum(dim=0).to(s.dtype))


def hyperadapt_gemm(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """((x·r)·w)·c; x: (..., d); w: (d, f); r: (d,) f32; c: (f,) f32.
    Leading dims of x are flattened into the kernel's row axis."""
    _check("hyperadapt_gemm", x, w, _hyperadapt_side(x, w, r, c))
    d, f = w.shape
    lead = x.shape[:-1]
    x2 = x.view(-1, d)
    if x.device.type == "cpu":
        return ref.ref_hyperadapt_gemm(x2, w, r, c).view(*lead, f)
    err, y = _hg.launch(x2, w, r, c)
    _launched("hyperadapt_gemm", err)
    return y.view(*lead, f)


def hyperadapt_merge(w: torch.Tensor, r: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """HyperAdapt absorption diag(r)·w·diag(c); w: (d, f); r: (d,) f32;
    c: (f,) f32."""
    _check("hyperadapt_merge", w, w, _hyperadapt_side(w, w, r, c))
    if w.device.type == "cpu":
        return ref.ref_hyperadapt_merge(w, r, c)
    err, out = _mm.launch_hyperadapt(w, r, c)
    _launched("hyperadapt_merge", err)
    return out


def hyperadapt_gemm_bwd(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
                        c: torch.Tensor, g: torch.Tensor, *, need_dw: bool):
    """(dx, dw, dr, dc) of :func:`hyperadapt_gemm` under cotangent g
    (..., f), composed as the JAX package's ``ops.hyperadapt_gemm_bwd``:
    z = (g·c)·wᵀ (w read transposed in place) and y0 = (x·r)·w on the
    forward kernel without its column scale, each in the activation
    dtype; dx = z·r, dr = Σ x⊙z, dc = Σ y0⊙g; dW = (x·r)ᵀ(g·c) on
    ``reflect_gemm_dw`` with a zero hyperplane, only when ``need_dw``
    (else None)."""
    _check("hyperadapt_gemm_bwd", x, w, _hyperadapt_side(x, w, r, c, g))
    if x.device.type == "cpu":
        return ref.ref_hyperadapt_gemm_bwd(x, w, r, c, g, need_dw=need_dw)
    d, f = w.shape
    x2, g2 = x.view(-1, d), g.view(-1, f)
    err, z = _hg.launch(g2, w, c, w_t=True)
    _launched("hyperadapt_gemm", err)
    err, y0 = _hg.launch(x2, w, r)
    _launched("hyperadapt_gemm", err)
    xf, gf, zf = x2.float(), g2.float(), z.float()
    dw = None
    if need_dw:
        err, dw = _dw.launch((xf * r).to(x.dtype), _zero_u(d, x.device),
                             (gf * c).to(g.dtype))
        _launched("reflect_gemm_dw", err)
    return ((zf * r).to(x.dtype).view(x.shape), dw, (xf * zf).sum(dim=0),
            (y0.float() * gf).sum(dim=0))


def hyperadapt_merge_bwd(w: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                         g: torch.Tensor, *, need_dw: bool = True):
    """(dw, dr, dc) of :func:`hyperadapt_merge` under cotangent g (d, f):
    dw is the merge kernel on g (the op is linear in w), launched only
    when ``need_dw`` (else None); dr and dc single reductions of w⊙g, as
    the JAX package's ``ops.hyperadapt_merge_bwd``."""
    side = _hyperadapt_side(w, w, r, c)
    side["g"] = (g, w.shape, w.dtype)
    _check("hyperadapt_merge_bwd", w, w, side)
    if w.device.type == "cpu":
        return ref.ref_hyperadapt_merge_bwd(w, r, c, g, need_dw=need_dw)
    dw = None
    if need_dw:
        err, dw = _mm.launch_hyperadapt(g, r, c)
        _launched("hyperadapt_merge", err)
    wg = w.float() * g.float()
    return dw, wg @ c, wg.T @ r


# ---------------------------------------------------------------------------
# The merges' backwards (weight-mode training)
# ---------------------------------------------------------------------------

def _planes_side(w: torch.Tensor, u: torch.Tensor, v: Optional[torch.Tensor],
                 g: torch.Tensor, dim: int):
    """:func:`_check`'s operands of a merge backward and its ``extra``:
    u (and v, of u's shape) float32 (n, db) with n·db = ``dim``, g like
    w."""
    shape = tuple(u.shape) if u.dim() == 2 else (-1, -1)
    side = {"u": (u, shape, _F32)}
    if v is not None:
        side["v"] = (v, shape, _F32)
    side["g"] = (g, tuple(w.shape), w.dtype)
    fits = u.dim() == 2 and u.shape[0] * u.shape[1] == dim and u.numel()
    return side, None if fits else (
        f"need u (n, db) with n·db = {dim}, the merged side of w")


def merge_left_bwd(w: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                   v: Optional[torch.Tensor] = None, *, need_dw: bool):
    """(dw, du[, dv]) of W' = H·W on w's input dim under cotangent g
    (d, f): ETHER's reflection (rank 1: the registry's
    ``ether_merge_bwd``), or ETHER+'s H⁺ with v (rank 2, dv too).  dw is
    None unless ``need_dw``, and then is not written.  w, g: (d, f)
    alike; u[/v]: (n, db) f32, n·db = d."""
    side, extra = _planes_side(w, u, v, g, w.shape[0] if w.dim() else -1)
    _check("merge_left_bwd", w, w, side, extra)
    if w.device.type == "cpu":
        return ref.ref_merge_left_bwd(w, u, g, v, need_dw=need_dw)
    err, *grads = _mb.launch_left(w, u, g, v, need_dw)
    _launched("merge_left_bwd", err)
    return tuple(grads)


def merge_right_bwd(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor):
    """(dw, du, dv) of W' = W·H̃⁺ on w's output dim (ETHER+'s right
    factor) under cotangent g (d, f).  w, g: (d, f) alike; u, v:
    (n_out, db_out) f32, n_out·db_out = f."""
    side, extra = _planes_side(w, u, v, g, w.shape[1] if w.dim() == 2
                               else -1)
    _check("merge_right_bwd", w, w, side, extra)
    if w.device.type == "cpu":
        # each row of w takes the rank-2 update: its plain backward
        return ref.ref_etherplus_reflect_bwd(w, u, v, g)
    err, dw, du, dv = _mb.launch_right(w, u, v, g)
    _launched("merge_right_bwd", err)
    return dw, du, dv


def etherplus_merge_bwd(w: torch.Tensor, u1: torch.Tensor, v1: torch.Tensor,
                        u2: Optional[torch.Tensor],
                        v2: Optional[torch.Tensor], g: torch.Tensor, *,
                        need_dw: bool):
    """(dw, du1, dv1, du2, dv2) of :func:`etherplus_merge` under cotangent
    g (d, f), composed as the JAX package's ``ops.etherplus_merge_bwd``:
    one-sided, the rank-2 ``merge_left_bwd``; two-sided, w1 = H⁺·w again
    (``etherplus_merge_left``, in w's dtype), ``merge_right_bwd`` on (w1,
    g) for dw1, du2, dv2, then ``merge_left_bwd`` on (w, dw1).  du2/dv2
    None one-sided; dw None unless ``need_dw``."""
    if u2 is None:
        dw, du1, dv1 = merge_left_bwd(w, u1, g, v1, need_dw=need_dw)
        return dw, du1, dv1, None, None
    d = w.shape[0] if w.dim() else -1
    if not (_ok(w, d, w, u1) and _twin_ok(u1, v1)
            and _side_ok(u2, v2, w.shape[1]) and u2.device == w.device
            and _g_ok(w, w, g) and g.device == w.device
            and g.is_contiguous()):
        _refuse("etherplus_merge_bwd", w, d,
                **_given(w=w, u=u1, v=v1, u2=u2, v2=v2, g=g))
    if w.device.type == "cpu":
        return ref.ref_etherplus_merge_bwd(w, u1, v1, u2, v2, g,
                                           need_dw=need_dw)
    err, w1 = _epm.launch_left(w, u1, v1)
    _launched("etherplus_merge_left", err)
    dw1, du2, dv2 = merge_right_bwd(w1, u2, v2, g)
    dw, du1, dv1 = merge_left_bwd(w, u1, dw1, v1, need_dw=need_dw)
    return dw, du1, dv1, du2, dv2


# ---------------------------------------------------------------------------
# Multi-tenant banks: sequence b of x (B, S, d) served by tenant ids[b]
# ---------------------------------------------------------------------------

def _check_bank(op: str, x: torch.Tensor, w: Optional[torch.Tensor],
                ids: torch.Tensor, side: dict) -> None:
    """The bank wrappers' check: x a (B, S, d) activation, w (d, f) in its
    dtype (None for the reflection alone), ids an int32 or int64 (B,)
    tensor, each bank operand of ``side`` (name → (tensor, shape, dtype);
    a shape holding a str names what the bank must be), all contiguous on
    one device.  The ids' values are not read (that would synchronise
    with the card): the kernels map them into [0, A).  Raises KernelInputError
    naming the first check the operands fail."""
    dev = x.device
    named = {"x": x, **({} if w is None else {"w": w}), "ids": ids,
             **{k: t for k, (t, _, _) in side.items()}}
    if (x.dtype in _hh.DTYPE_CODE and x.dim() == 3
            and (w is None or (w.dtype == x.dtype and w.dim() == 2
                               and w.shape[0] == x.shape[2]))
            and ids.dtype in _ID_DTYPES and ids.shape == x.shape[:1]
            and all(t.dtype == dt and t.shape == shape
                    for t, shape, dt in side.values())
            and all(t.device == dev and t.is_contiguous()
                    for t in named.values())
            and dev.type in ("cpu", "cuda") and x.numel() > 0
            and (w is None or w.numel() > 0)):
        return
    bad = [k for k, (t, shape, dt) in side.items()
           if t.dtype != dt or t.shape != shape]
    if x.dtype not in _hh.DTYPE_CODE:
        why = "the kernel takes float32 or bfloat16 activations and weights"
    elif x.dim() != 3:
        why = "x must be a (B, S, d) batch of sequences"
    elif w is not None and (w.dim() != 2 or w.dtype != x.dtype):
        why = "w must be a (d, f) matrix in the activations' dtype"
    elif w is not None and w.shape[0] != x.shape[2]:
        why = "need x (B, S, d) and w (d, f)"
    elif ids.dtype not in _ID_DTYPES or ids.shape != x.shape[:1]:
        why = "ids must be an int32 or int64 (B,) tensor, one id a sequence"
    elif bad:
        _, shape, dt = side[bad[0]]
        why = f"{bad[0]} must be {str(dt)[6:]} of shape {tuple(shape)}"
    elif len({t.device for t in named.values()}) != 1:
        why = "all operands must be on one device"
    elif dev.type not in ("cpu", "cuda"):
        why = "operands must be on the CPU or a CUDA device"
    elif not all(t.is_contiguous() for t in named.values()):
        why = "operands must be contiguous"
    else:
        why = "operands must not be empty"
    desc = ", ".join(f"{k} {tuple(t.shape)} {t.dtype} on {t.device}"
                     for k, t in named.items())
    raise KernelInputError(f"{op} refuses {desc}: {why}")


def _planes(bank: torch.Tensor, d: int) -> tuple:
    """The shape a hyperplane bank must have: its own when it is (A, n, db)
    with A ≥ 1 and n·db = d, else a description of that."""
    if (bank.dim() == 3 and bank.shape[0] >= 1
            and bank.shape[1] * bank.shape[2] == d):
        return tuple(bank.shape)
    return ("A ≥ 1", "n", f"db with n·db = {d}")


def _bank_size(bank: torch.Tensor, ndim: int) -> int:
    """A, the bank's tenant count (-1 where it has not ``ndim`` dims or
    no tenant)."""
    return bank.shape[0] if bank.dim() == ndim and bank.shape[0] >= 1 else -1


def householder_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                             u_bank: torch.Tensor,
                             ids: torch.Tensor) -> torch.Tensor:
    """reflect_{ids[b]}(x[b]) @ w; x: (B, S, d); w: (d, f); u_bank:
    (A, n, db) f32 with n·db = d; ids: (B,) int32 or int64."""
    d = x.shape[-1] if x.dim() else -1
    _check_bank("householder_gemm_batched", x, w, ids,
                {"u_bank": (u_bank, _planes(u_bank, d), _F32)})
    if x.device.type == "cpu":
        return ref.ref_householder_gemm_batched(x, w, u_bank, ids)
    err, y = _bk.householder_gemm_batched(x, w, u_bank, ids)
    _launched("householder_gemm_batched", err)
    return y


def etherplus_reflect_batched(x: torch.Tensor, u_bank: torch.Tensor,
                              v_bank: torch.Tensor,
                              ids: torch.Tensor) -> torch.Tensor:
    """H⁺_{ids[b]} x[b]; x: (B, S, d); u_bank/v_bank: (A, n, db) f32 of one
    shape with n·db = d; ids: (B,) int32 or int64."""
    d = x.shape[-1] if x.dim() else -1
    shape = _planes(u_bank, d)
    _check_bank("etherplus_reflect_batched", x, None, ids,
                {"u_bank": (u_bank, shape, _F32),
                 "v_bank": (v_bank, shape, _F32)})
    if x.device.type == "cpu":
        return ref.ref_etherplus_reflect_batched(x, u_bank, v_bank, ids)
    err, out = _bk.etherplus_reflect_batched(x, u_bank, v_bank, ids)
    _launched("etherplus_reflect_batched", err)
    return out


def delora_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                        a_bank: torch.Tensor, b_bank: torch.Tensor,
                        s_bank: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """x[b]·w + ((x[b]·a_t)·s_t)·b_t, t = ids[b]; x: (B, S, d); w: (d, f);
    a_bank: (A, d, r) f32; b_bank: (A, r, f) f32; s_bank: (A, r) in x's
    dtype, r ≥ 1; ids: (B,) int32 or int64."""
    d, f = _dims(x, w)
    a = _bank_size(a_bank, 3)
    r = a_bank.shape[2] if a_bank.dim() == 3 and a_bank.shape[2] else -1
    _check_bank("delora_gemm_batched", x, w, ids,
                {"a_bank": (a_bank, (a, d, r), _F32),
                 "b_bank": (b_bank, (a, r, f), _F32),
                 "s_bank": (s_bank, (a, r), x.dtype)})
    if x.device.type == "cpu":
        return ref.ref_delora_gemm_batched(x, w, a_bank, b_bank, s_bank, ids)
    err, y = _bk.delora_gemm_batched(x, w, a_bank, b_bank, s_bank, ids)
    _launched("delora_gemm_batched", err)
    return y


def hyperadapt_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                            r_bank: torch.Tensor, c_bank: torch.Tensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """((x[b]·r_t)·w)·c_t, t = ids[b]; x: (B, S, d); w: (d, f); r_bank:
    (A, d) f32; c_bank: (A, f) f32; ids: (B,) int32 or int64."""
    d, f = _dims(x, w)
    a = _bank_size(r_bank, 2)
    _check_bank("hyperadapt_gemm_batched", x, w, ids,
                {"r_bank": (r_bank, (a, d), _F32),
                 "c_bank": (c_bank, (a, f), _F32)})
    if x.device.type == "cpu":
        return ref.ref_hyperadapt_gemm_batched(x, w, r_bank, c_bank, ids)
    err, y = _bk.hyperadapt_gemm_batched(x, w, r_bank, c_bank, ids)
    _launched("hyperadapt_gemm_batched", err)
    return y
