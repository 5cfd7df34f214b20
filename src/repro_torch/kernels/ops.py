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
``delora_gemm_batched`` is a short pass and a GEMM;
``householder_gemm_batched_bwd`` launches its kernel, and
``householder_gemm_batched_dw`` only when asked for dW;
``etherplus_reflect_batched_bwd`` its kernel; ``delora_gemm_batched_bwd``
launches ``delora_gemm_batched`` for dx and ``hyperadapt_gemm_batched_bwd``
``hyperadapt_gemm_batched`` twice, for z and y0, each ``reflect_gemm_dw``
with a zero hyperplane only when asked for dW; ``ssd_chunk`` launches
the SSD kernel once a call; the registry's standalone reflections
``ether_reflect``, ``ether_reflect_batched``, ``ether_reflect_bwd`` and
``ether_reflect_batched_bwd`` launch their one kernel each, the
backwards' fixed-order ĝ sums and norm chain included; ``flash_attention``
counts one launch a call, on any route, its decode route's combine of
the splits included), so a run can show that its path went
through the kernels; ``routes()`` splits ``householder_gemm``'s launches
by the route each took (``wgmma``, ``wgmma_decode`` or ``simt``), and
``routes("flash_attention")`` the flash kernel's (``wgmma``, ``decode``
or ``simt``), and ``routes("reflect_gemm_dx")`` and
``routes("householder_gemm_batched_bwd")`` the dXr backwards' (``wgmma``
or ``simt``, rank-2 calls included), ``routes("etherplus_gemm")`` and
``routes("householder_gemm_batched")`` the forwards of ETHER+ and of the
bank (``wgmma`` or ``simt``; the backward's y0 recompute included), and
``routes("hyperadapt_gemm_batched")`` and ``routes("hyperadapt_gemm")``
HyperAdapt's, through a bank and with one tenant (``wgmma`` or ``simt``;
the backward's z and y0 included), and ``routes("delora_gemm_batched")``
the DeLoRA bank's (``wgmma`` or ``simt``; its backward's dx included).  The
rank-r and per-feature cotangents of DeLoRA and HyperAdapt (and their
scatter-add over a bank's ids) are a few thin PyTorch ops beside the
kernels, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import batched as _bk
from repro_torch.kernels import delora_gemm as _dg
from repro_torch.kernels import ether_merge as _merge
from repro_torch.kernels import ether_reflect as _er
from repro_torch.kernels import ether_reflect_bwd as _erb
from repro_torch.kernels import etherplus_gemm as _ep
from repro_torch.kernels import etherplus_merge as _epm
from repro_torch.kernels import etherplus_reflect_bwd as _rb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import householder_gemm as _hh
from repro_torch.kernels import hyperadapt_gemm as _hg
from repro_torch.kernels import merge_bwd as _mb
from repro_torch.kernels import method_merge as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import reflect_gemm_dw as _dw
from repro_torch.kernels import reflect_gemm_dx as _dx
from repro_torch.kernels import ssd_scan as _ssd

_LAUNCHES = {"householder_gemm": 0, "ether_merge": 0, "reflect_gemm_dx": 0,
             "reflect_gemm_dw": 0, "etherplus_gemm": 0,
             "etherplus_merge_left": 0, "etherplus_merge_right": 0,
             "etherplus_reflect_bwd": 0, "delora_gemm": 0,
             "hyperadapt_gemm": 0, "delora_merge": 0, "hyperadapt_merge": 0,
             "householder_gemm_batched": 0, "etherplus_reflect_batched": 0,
             "delora_gemm_batched": 0, "hyperadapt_gemm_batched": 0,
             "merge_left_bwd": 0, "merge_right_bwd": 0,
             "householder_gemm_batched_bwd": 0,
             "householder_gemm_batched_dw": 0,
             "etherplus_reflect_batched_bwd": 0, "ssd_chunk": 0,
             "ether_reflect": 0, "ether_reflect_batched": 0,
             "ether_reflect_bwd": 0, "ether_reflect_batched_bwd": 0,
             "flash_attention": 0}
# launches by route of the kernels that have routes
# (``householder_gemm.ROUTES``, ``flash_attention.ROUTES``, the dXr
# backwards' ``reflect_gemm_dx.ROUTES``, ``etherplus_gemm.ROUTES``, the
# bank forward's ``batched.GEMM_ROUTES``, ``batched.HA_ROUTES`` and
# ``batched.DL_ROUTES``, ``hyperadapt_gemm.ROUTES``)
_ROUTES = {"householder_gemm": dict.fromkeys(_hh.ROUTES, 0),
           "flash_attention": dict.fromkeys(_fa.ROUTES, 0),
           "reflect_gemm_dx": dict.fromkeys(_dx.ROUTES, 0),
           "householder_gemm_batched_bwd": dict.fromkeys(_dx.ROUTES, 0),
           "etherplus_gemm": dict.fromkeys(_ep.ROUTES, 0),
           "householder_gemm_batched": dict.fromkeys(_bk.GEMM_ROUTES, 0),
           "hyperadapt_gemm_batched": dict.fromkeys(_bk.HA_ROUTES, 0),
           "hyperadapt_gemm": dict.fromkeys(_hg.ROUTES, 0),
           "delora_gemm_batched": dict.fromkeys(_bk.DL_ROUTES, 0)}
_F32 = torch.float32
_ID_DTYPES = (torch.int32, torch.int64)


class KernelInputError(ValueError):
    """A wrapper refused its inputs (device, dtype, shape or layout)."""


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a kernel launch."""


def launches() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return dict(_LAUNCHES)


def routes(op: str = "householder_gemm") -> dict[str, int]:
    """``op``'s launches per route since the last reset, as
    ``<op>.<route>``; they add up to its entry in :func:`launches`.  ``op``
    is ``householder_gemm``, ``flash_attention``, ``reflect_gemm_dx``,
    ``householder_gemm_batched_bwd``, ``etherplus_gemm``,
    ``householder_gemm_batched``, ``hyperadapt_gemm_batched``,
    ``hyperadapt_gemm`` or ``delora_gemm_batched``."""
    return {f"{op}.{r}": v for r, v in _ROUTES[op].items()}


def reset_launches() -> None:
    """Set every launch and route count to 0."""
    for counts in (_LAUNCHES, *_ROUTES.values()):
        for k in counts:
            counts[k] = 0


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
    Leading dims of x are flattened into the kernel's row axis.  On the
    card it launches the route :func:`householder_gemm.route` picks
    (``wgmma``, ``wgmma_decode`` or ``simt``), counted in :func:`routes`."""
    if not _ok(x, x.shape[-1] if x.dim() else -1, w, u):
        _refuse("householder_gemm", x, x.shape[-1] if x.dim() else -1,
                x=x, w=w, u=u)
    d, f = w.shape
    lead = x.shape[:-1]
    x2 = x.view(-1, d)
    if x.device.type == "cpu":
        return ref.ref_householder_gemm(x2, w, u).view(*lead, f)
    err, y, on = _hh.launch(x2, w, u)
    _launched("householder_gemm", err)
    _ROUTES["householder_gemm"][on] += 1
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
    on = _dx.pick(x2, w, u, g2)
    err, dx, du = _dx.launch(x2, w, u, g2, on=on)
    _launched("reflect_gemm_dx", err)
    _ROUTES["reflect_gemm_dx"][on] += 1
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
    flattened into the kernel's row axis.  On the card it launches the
    route :func:`etherplus_gemm.route` picks (``wgmma`` or ``simt``),
    counted in ``routes("etherplus_gemm")``."""
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
    err, y, on = _ep.launch(x2, w, u1, v1, u2, v2)
    _launched("etherplus_gemm", err)
    _ROUTES["etherplus_gemm"][on] += 1
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
        err, y0, on = _ep.launch(x2, w, u1, v1)
        _launched("etherplus_gemm", err)
        _ROUTES["etherplus_gemm"][on] += 1
        err, dy0, du2, dv2 = _rb.launch(y0, u2, v2, g2)
        _launched("etherplus_reflect_bwd", err)
    on = _dx.pick(x2, w, u1, dy0, v1)
    err, dx, du1, dv1 = _dx.launch(x2, w, u1, dy0, v1, on=on)
    _launched("reflect_gemm_dx", err)
    _ROUTES["reflect_gemm_dx"][on] += 1
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
    Leading dims of x are flattened into the kernel's row axis.  On the
    card it launches the route :func:`hyperadapt_gemm.route` picks
    (``wgmma`` or ``simt``), counted in ``routes("hyperadapt_gemm")``."""
    _check("hyperadapt_gemm", x, w, _hyperadapt_side(x, w, r, c))
    d, f = w.shape
    lead = x.shape[:-1]
    x2 = x.view(-1, d)
    if x.device.type == "cpu":
        return ref.ref_hyperadapt_gemm(x2, w, r, c).view(*lead, f)
    err, y, on = _hg.launch(x2, w, r, c)
    _launched("hyperadapt_gemm", err)
    _ROUTES["hyperadapt_gemm"][on] += 1
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
    err, z, on = _hg.launch(g2, w, c, w_t=True)
    _launched("hyperadapt_gemm", err)
    _ROUTES["hyperadapt_gemm"][on] += 1
    err, y0, on = _hg.launch(x2, w, r)
    _launched("hyperadapt_gemm", err)
    _ROUTES["hyperadapt_gemm"][on] += 1
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
    (A, n, db) f32 with n·db = d; ids: (B,) int32 or int64.  On the card
    it launches the route :func:`batched.gemm_route` picks (``wgmma`` or
    ``simt``), counted in ``routes("householder_gemm_batched")``."""
    d = x.shape[-1] if x.dim() else -1
    _check_bank("householder_gemm_batched", x, w, ids,
                {"u_bank": (u_bank, _planes(u_bank, d), _F32)})
    if x.device.type == "cpu":
        return ref.ref_householder_gemm_batched(x, w, u_bank, ids)
    err, y, on = _bk.householder_gemm_batched(x, w, u_bank, ids)
    _launched("householder_gemm_batched", err)
    _ROUTES["householder_gemm_batched"][on] += 1
    return y


def etherplus_reflect_batched(x: torch.Tensor, u_bank: torch.Tensor,
                              v_bank: torch.Tensor,
                              ids: torch.Tensor) -> torch.Tensor:
    """H⁺_{ids[b]} x[b]; x: (B, S, d); u_bank/v_bank: (A, n, db) f32 of one
    shape with n·db = d; ids: (B,) int32 or int64.  On the card it
    launches csrc/rank2_tiles.cuh's tile kernel at
    :func:`batched.rank2_geometry`."""
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
    dtype, r ≥ 1; ids: (B,) int32 or int64.  On the card it launches the
    route :func:`batched.delora_route` picks (``wgmma`` or ``simt``),
    counted in ``routes("delora_gemm_batched")``."""
    d, f = _dims(x, w)
    a = _bank_size(a_bank, 3)
    r = a_bank.shape[2] if a_bank.dim() == 3 and a_bank.shape[2] else -1
    _check_bank("delora_gemm_batched", x, w, ids,
                {"a_bank": (a_bank, (a, d, r), _F32),
                 "b_bank": (b_bank, (a, r, f), _F32),
                 "s_bank": (s_bank, (a, r), x.dtype)})
    if x.device.type == "cpu":
        return ref.ref_delora_gemm_batched(x, w, a_bank, b_bank, s_bank, ids)
    err, y, on = _bk.delora_gemm_batched(x, w, a_bank, b_bank, s_bank, ids)
    _launched("delora_gemm_batched", err)
    _ROUTES["delora_gemm_batched"][on] += 1
    return y


def hyperadapt_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                            r_bank: torch.Tensor, c_bank: torch.Tensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """((x[b]·r_t)·w)·c_t, t = ids[b]; x: (B, S, d); w: (d, f); r_bank:
    (A, d) f32; c_bank: (A, f) f32; ids: (B,) int32 or int64.  On the card
    it launches the route :func:`batched.hyperadapt_route` picks
    (``wgmma`` or ``simt``), counted in
    ``routes("hyperadapt_gemm_batched")``."""
    d, f = _dims(x, w)
    a = _bank_size(r_bank, 2)
    _check_bank("hyperadapt_gemm_batched", x, w, ids,
                {"r_bank": (r_bank, (a, d), _F32),
                 "c_bank": (c_bank, (a, f), _F32)})
    if x.device.type == "cpu":
        return ref.ref_hyperadapt_gemm_batched(x, w, r_bank, c_bank, ids)
    err, y, on = _bk.hyperadapt_gemm_batched(x, w, r_bank, c_bank, ids)
    _launched("hyperadapt_gemm_batched", err)
    _ROUTES["hyperadapt_gemm_batched"][on] += 1
    return y


# ---------------------------------------------------------------------------
# Training through a bank: the bank forwards' backwards
# ---------------------------------------------------------------------------

def _cotangent(x: torch.Tensor, f: int) -> tuple:
    """The shape a bank op's cotangent must have: x's leading dims and f."""
    return (*x.shape[:-1], f) if x.dim() else (-1,)


def householder_gemm_batched_bwd(x: torch.Tensor, w: torch.Tensor,
                                 u_bank: torch.Tensor, ids: torch.Tensor,
                                 g: torch.Tensor, *, need_dw: bool):
    """(dx, dw, du_bank) of :func:`householder_gemm_batched` under cotangent
    g (B, S, f); dw is None unless ``need_dw``, and its kernel
    (``householder_gemm_batched_dw``) then does not run.  du_bank (A, n,
    db) f32: each sequence's dL/dû summed over the ids that name a tenant
    (duplicates add, an id mapped into [0, A) as the forward maps it), an
    exact zero for a tenant no id names."""
    d = x.shape[-1] if x.dim() else -1
    f = w.shape[1] if w.dim() == 2 else -1
    _check_bank("householder_gemm_batched_bwd", x, w, ids,
                {"u_bank": (u_bank, _planes(u_bank, d), _F32),
                 "g": (g, _cotangent(x, f), x.dtype)})
    if x.device.type == "cpu":
        return ref.ref_householder_gemm_batched_grads(x, w, u_bank, ids, g,
                                                      need_dw=need_dw)
    on = _bk.pick_bwd(x, w, u_bank, g)
    err, dx, _, du = _bk.householder_gemm_batched_bwd(x, w, u_bank, ids, g,
                                                       on=on)
    _launched("householder_gemm_batched_bwd", err)
    _ROUTES["householder_gemm_batched_bwd"][on] += 1
    dw = None
    if need_dw:
        err, dw = _bk.householder_gemm_batched_dw(x, u_bank, ids, g)
        _launched("householder_gemm_batched_dw", err)
    return dx, dw, du


def etherplus_reflect_batched_bwd(x: torch.Tensor, u_bank: torch.Tensor,
                                  v_bank: torch.Tensor, ids: torch.Tensor,
                                  g: torch.Tensor):
    """(dx, du_bank, dv_bank) of :func:`etherplus_reflect_batched` under
    cotangent g (B, S, d), the bank gradients as
    :func:`householder_gemm_batched_bwd` forms them.  On the card it
    launches csrc/rank2_tiles.cuh's tile kernel and its ĝ and norm-chain
    kernel, one launch counted."""
    d = x.shape[-1] if x.dim() else -1
    shape = _planes(u_bank, d)
    _check_bank("etherplus_reflect_batched_bwd", x, None, ids,
                {"u_bank": (u_bank, shape, _F32),
                 "v_bank": (v_bank, shape, _F32),
                 "g": (g, _cotangent(x, d), x.dtype)})
    if x.device.type == "cpu":
        return ref.ref_etherplus_reflect_batched_grads(x, u_bank, v_bank,
                                                       ids, g)
    err, dx, _, _, du, dv = _bk.etherplus_reflect_batched_bwd(
        x, u_bank, v_bank, ids, g)
    _launched("etherplus_reflect_batched_bwd", err)
    return dx, du, dv


def delora_gemm_batched_bwd(x: torch.Tensor, w: torch.Tensor,
                            a_bank: torch.Tensor, b_bank: torch.Tensor,
                            s_bank: torch.Tensor, ids: torch.Tensor,
                            g: torch.Tensor, *, need_dw: bool):
    """(dx, dw, da_bank, db_bank, ds_bank) of :func:`delora_gemm_batched`
    under cotangent g (B, S, f), composed as the JAX package's
    ``ops.delora_gemm_batched_bwd``: dx = g·wᵀ + ((g·b_tᵀ)·s_t)·a_tᵀ on the
    bank forward kernel with w read transposed in place and the banks
    read where they lie (no transposed copies); dW = xᵀg on
    ``reflect_gemm_dw`` with a zero hyperplane, only when ``need_dw``
    (else None); the adapters' cotangents rank-r contractions per
    sequence, scatter-added over the ids."""
    d, f = _dims(x, w)
    a = _bank_size(a_bank, 3)
    r = a_bank.shape[2] if a_bank.dim() == 3 and a_bank.shape[2] else -1
    _check_bank("delora_gemm_batched_bwd", x, w, ids,
                {"a_bank": (a_bank, (a, d, r), _F32),
                 "b_bank": (b_bank, (a, r, f), _F32),
                 "s_bank": (s_bank, (a, r), x.dtype),
                 "g": (g, _cotangent(x, f), x.dtype)})
    if x.device.type == "cpu":
        return ref.ref_delora_gemm_batched_bwd(x, w, a_bank, b_bank, s_bank,
                                               ids, g, need_dw=need_dw)
    err, dx, on = _bk.delora_gemm_batched(g, w, a_bank, b_bank, s_bank, ids,
                                          w_t=True, dx=True)
    _launched("delora_gemm_batched", err)
    _ROUTES["delora_gemm_batched"][on] += 1
    dw = None
    if need_dw:
        err, dw = _dw.launch(x.view(-1, d), _zero_u(d, x.device),
                             g.view(-1, f))
        _launched("reflect_gemm_dw", err)
    return (dx, dw, *ref.delora_bank_cotangents(x, g, a_bank, b_bank,
                                                s_bank, ids))


def hyperadapt_gemm_batched_bwd(x: torch.Tensor, w: torch.Tensor,
                                r_bank: torch.Tensor, c_bank: torch.Tensor,
                                ids: torch.Tensor, g: torch.Tensor, *,
                                need_dw: bool):
    """(dx, dw, dr_bank, dc_bank) of :func:`hyperadapt_gemm_batched` under
    cotangent g (B, S, f), composed as the JAX package's
    ``ops.hyperadapt_gemm_batched_bwd``: z = (g·c_t)·wᵀ (w read transposed
    in place) and y0 = (x·r_t)·w on the bank forward kernel without its
    column scale, each in the activation dtype; dx = z·r_t and the
    per-sequence sums Σ x⊙z, Σ y0⊙g scatter-added over the ids; dW =
    (x·r_t)ᵀ(g·c_t) on ``reflect_gemm_dw`` with a zero hyperplane, only
    when ``need_dw`` (else None)."""
    d, f = _dims(x, w)
    a = _bank_size(r_bank, 2)
    _check_bank("hyperadapt_gemm_batched_bwd", x, w, ids,
                {"r_bank": (r_bank, (a, d), _F32),
                 "c_bank": (c_bank, (a, f), _F32),
                 "g": (g, _cotangent(x, f), x.dtype)})
    if x.device.type == "cpu":
        return ref.ref_hyperadapt_gemm_batched_bwd(x, w, r_bank, c_bank, ids,
                                                   g, need_dw=need_dw)
    err, z, on = _bk.hyperadapt_gemm_batched(g, w, c_bank, None, ids,
                                             w_t=True)
    _launched("hyperadapt_gemm_batched", err)
    _ROUTES["hyperadapt_gemm_batched"][on] += 1
    err, y0, on = _bk.hyperadapt_gemm_batched(x, w, r_bank, None, ids)
    _launched("hyperadapt_gemm_batched", err)
    _ROUTES["hyperadapt_gemm_batched"][on] += 1
    dw = None
    if need_dw:
        xr, gc = ref.hyperadapt_bank_scaled(x, g, r_bank, c_bank, ids)
        err, dw = _dw.launch(xr, _zero_u(d, x.device), gc)
        _launched("reflect_gemm_dw", err)
    dx, dr, dc = ref.hyperadapt_bank_cotangents(x, g, z, y0, r_bank, c_bank,
                                                ids)
    return dx, dw, dr, dc


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunk scan
# ---------------------------------------------------------------------------

SSD_MAX_CHUNK, SSD_MAX_STATE = 256, 256


def _check_ssd(xv: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, chunk: int) -> None:
    """``ssd_chunk``'s check: xv (B, S, H, P) f32, a (B, S, H) f32, b and
    c (B, S, G, N) of one dtype, f32 or bf16, with H % G == 0,
    N ≤ SSD_MAX_STATE, 1 ≤ chunk ≤ SSD_MAX_CHUNK and S % chunk == 0, all
    contiguous on one device.  Raises KernelInputError naming the first
    check the operands fail."""
    named = {"xv": xv, "a": a, "b": b, "c": c}
    shaped = xv.dim() == 4 and b.dim() == 4
    B, S, H, P = xv.shape if xv.dim() == 4 else (-1,) * 4
    G, N = b.shape[2:] if b.dim() == 4 else (-1, -1)
    if not (xv.dtype == _F32 and shaped):
        why = "xv must be a float32 (B, S, H, P) tensor"
    elif a.dtype != _F32 or a.shape != (B, S, H):
        why = "a must be float32 of shape (B, S, H)"
    elif (b.shape[:2] != (B, S) or c.shape != b.shape
          or b.dtype not in _ssd.DTYPE_CODE or c.dtype != b.dtype):
        why = ("b and c must be (B, S, G, N) tensors of one dtype, float32 "
               "or bfloat16")
    elif G < 1 or H % G or not 1 <= N <= SSD_MAX_STATE:
        why = (f"need H % G == 0 and 1 ≤ N ≤ {SSD_MAX_STATE} (the kernel "
               f"stages 128 rows of N floats in shared memory)")
    elif not 1 <= chunk <= SSD_MAX_CHUNK:
        why = f"chunk must lie in [1, {SSD_MAX_CHUNK}]"
    elif S % chunk:
        why = "S must be a multiple of chunk (ssd_chunked pads)"
    elif len({t.device for t in named.values()}) != 1:
        why = "all operands must be on one device"
    elif xv.device.type not in ("cpu", "cuda"):
        why = "operands must be on the CPU or a CUDA device"
    elif not all(t.is_contiguous() for t in named.values()):
        why = "operands must be contiguous"
    elif xv.numel() == 0 or b.numel() == 0:
        why = "operands must not be empty"
    else:
        return
    desc = ", ".join(f"{k} {tuple(t.shape)} {t.dtype} on {t.device}"
                     for k, t in named.items())
    raise KernelInputError(f"ssd_chunk refuses {desc}, chunk {chunk}: {why}")


def ssd_chunk(xv: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, chunk: int):
    """The SSD intra-chunk dual form over chunks of ``chunk`` steps: xv
    (B, S, H, P) f32, a (B, S, H) f32, b and c (B, S, G, N) f32 or bf16
    (head h reads group h // (H/G)), S % chunk == 0.  Returns (y_intra
    (B, S, H, P), states (B, H, nc, N, P), decays (B, H, nc)), float32;
    see :func:`repro_torch.kernels.ref.ref_ssd_chunk`."""
    _check_ssd(xv, a, b, c, chunk)
    if xv.device.type == "cpu":
        return ref.ref_ssd_chunk(xv, a, b, c, chunk)
    err, y, states, decays = _ssd.launch(xv, a, b, c, chunk)
    _launched("ssd_chunk", err)
    return y, states, decays


# ---------------------------------------------------------------------------
# The registry's standalone reflections (no GEMM), forward and backward
# ---------------------------------------------------------------------------

def _check_reflect(op: str, x: torch.Tensor, u: torch.Tensor,
                   g: Optional[torch.Tensor] = None) -> None:
    """The single-tenant reflection wrappers' check: x (..., d) float32 or
    bfloat16, u a float32 (n, db) tensor with n·db = d [, g like x], all
    contiguous on one device, x not empty.  Raises KernelInputError naming
    the first check the operands fail."""
    d = x.shape[-1] if x.dim() else -1
    named = {"x": x, "u": u, **({} if g is None else {"g": g})}
    dev = x.device
    if (x.dtype in _hh.DTYPE_CODE and u.dtype == _F32 and u.dim() == 2
            and u.shape[0] * u.shape[1] == d
            and (g is None or (g.dtype == x.dtype and g.shape == x.shape))
            and all(t.device == dev and t.is_contiguous()
                    for t in named.values())
            and dev.type in ("cpu", "cuda") and x.numel() > 0):
        return
    if x.dtype not in _hh.DTYPE_CODE:
        why = "the kernel takes float32 or bfloat16 activations"
    elif u.dtype != _F32 or u.dim() != 2:
        why = "u must be a float32 (n, db) tensor"
    elif u.shape[0] * u.shape[1] != d:
        why = "need x (..., d) and u (n, db) with n·db = d"
    elif g is not None and (g.dtype != x.dtype or g.shape != x.shape):
        why = "g must have x's shape and dtype"
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


def ether_reflect(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """H_B x over the last dim; x: (..., d), any leading dims, flattened
    into the kernel's row axis; u: (n, db) f32, n·db = d.  Every shape:
    the JAX wrapper's fallback to jnp for T % 256 ≠ 0 has no counterpart."""
    _check_reflect("ether_reflect", x, u)
    if x.device.type == "cpu":
        return ref.ref_ether_reflect(x, u)
    err, out = _er.launch(x.view(-1, x.shape[-1]), u)
    _launched("ether_reflect", err)
    return out.view(x.shape)


def ether_reflect_bwd(x: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """(dx, du) of :func:`ether_reflect` under cotangent g (x's shape and
    dtype): dx in x's dtype, du (n, db) f32 summed over every row in a
    fixed order."""
    _check_reflect("ether_reflect_bwd", x, u, g)
    if x.device.type == "cpu":
        return ref.ref_ether_reflect_bwd(x, u, g)
    d = x.shape[-1]
    err, dx, du = _erb.launch(x.view(-1, d), u, g.view(-1, d))
    _launched("ether_reflect_bwd", err)
    return dx.view(x.shape), du


def ether_reflect_batched(x: torch.Tensor, u_bank: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """R_{ids[b]} x[b]; x: (B, S, d), any S; u_bank: (A, n, db) f32 with
    n·db = d; ids: (B,) int32 or int64, mapped into [0, A) on the
    device."""
    d = x.shape[-1] if x.dim() else -1
    _check_bank("ether_reflect_batched", x, None, ids,
                {"u_bank": (u_bank, _planes(u_bank, d), _F32)})
    if x.device.type == "cpu":
        return ref.ref_ether_reflect_batched(x, u_bank, ids)
    err, out = _er.launch_batched(x, u_bank, ids)
    _launched("ether_reflect_batched", err)
    return out


def ether_reflect_batched_bwd(x: torch.Tensor, u_bank: torch.Tensor,
                              ids: torch.Tensor, g: torch.Tensor):
    """(dx, du_bank) of :func:`ether_reflect_batched` under cotangent g
    (B, S, d), du_bank (A, n, db) f32 as
    :func:`householder_gemm_batched_bwd` forms it: each sequence's dL/dû
    summed over the ids that name a tenant, an exact zero for a tenant no
    id names."""
    d = x.shape[-1] if x.dim() else -1
    _check_bank("ether_reflect_batched_bwd", x, None, ids,
                {"u_bank": (u_bank, _planes(u_bank, d), _F32),
                 "g": (g, _cotangent(x, d), x.dtype)})
    if x.device.type == "cpu":
        return ref.ref_ether_reflect_batched_bwd(x, u_bank, ids, g)
    err, dx, _, du = _erb.launch_batched(x, u_bank, ids, g)
    _launched("ether_reflect_batched_bwd", err)
    return dx, du


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

_I32 = 2 ** 31 - 1


def _flash_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int], q_offset: int) -> Optional[str]:
    """Why ``flash_attention`` refuses these operands, or None where it
    takes them: q (B, H, S, D), k and v (B, Hkv, T, D) of one dtype,
    float32 or bfloat16, H % Hkv == 0, D in ``flash_attention.HEAD_DIMS``,
    S, T ≥ 1, all contiguous on one device (16-byte aligned on the card);
    window None or an int, q_offset an int, both in int32 range.  The
    first check the operands fail is named.  ``execute``'s ``auto`` rule
    for the op asks the same question."""
    named = {"q": q, "k": k, "v": v}
    shaped = q.dim() == 4 and k.dim() == 4
    B, H, S, D = q.shape if q.dim() == 4 else (-1,) * 4
    Hkv, T = k.shape[1:3] if k.dim() == 4 else (-1, -1)
    if not shaped or q.dtype not in _fa.DTYPE_CODE:
        why = "q must be a float32 or bfloat16 (B, H, S, D) tensor"
    elif (k.shape != (B, Hkv, T, D) or v.shape != k.shape
          or k.dtype != q.dtype or v.dtype != q.dtype):
        why = "k and v must be (B, Hkv, T, D) tensors of q's dtype"
    elif Hkv < 1 or H % Hkv:
        why = "the query heads must be a multiple of the KV heads"
    elif D not in _fa.HEAD_DIMS:
        why = f"the kernel takes head widths {_fa.HEAD_DIMS}"
    elif S < 1 or T < 1 or B < 1:
        why = "operands must not be empty"
    elif not (isinstance(q_offset, int) and abs(q_offset) <= _I32
              and (window is None or (isinstance(window, int)
                                      and abs(window) <= _I32))):
        why = "q_offset and window must be ints in int32 range"
    elif len({t.device for t in named.values()}) != 1:
        why = "all operands must be on one device"
    elif q.device.type not in ("cpu", "cuda"):
        why = "operands must be on the CPU or a CUDA device"
    elif not all(t.is_contiguous() for t in named.values()):
        why = "operands must be contiguous"
    elif q.device.type == "cuda" and any(t.data_ptr() % 16
                                         for t in named.values()):
        why = "operands must be 16-byte aligned on the card"
    else:
        why = None
    return why


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int], q_offset: int) -> None:
    """Raise KernelInputError where :func:`_flash_refusal` refuses."""
    why = _flash_refusal(q, k, v, window, q_offset)
    if why is None:
        return
    desc = ", ".join(f"{k} {tuple(t.shape)} {t.dtype} on {t.device}"
                     for k, t in (("q", q), ("k", k), ("v", v)))
    raise KernelInputError(f"flash_attention refuses {desc}, window "
                           f"{window!r}, q_offset {q_offset!r}: {why}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    q_chunk: Optional[int] = None) -> torch.Tensor:
    """Softmax attention of q (B, H, S, D) against k, v (B, Hkv, T, D),
    KV head h // (H/Hkv) for query head h, scale 1/√D: query row i sits
    at ``q_offset + i`` against keys 0..T−1 (causal: kpos ≤ qpos;
    ``window``: kpos > qpos − window), a row with no valid key is exact
    zeros.  Returns (B, H, S, D) in q's dtype.  The counterpart of the JAX
    package's ``ops.flash_attention``, at every S and T: its fallback for
    shapes not tileable by 128, which drops ``q_offset``, has none (see
    :func:`repro_torch.kernels.ref.ref_flash_attention`).  ``q_chunk``
    bounds the plain version's live scores on the CPU; the kernel walks
    its own tiles.  On the card it launches the route
    :func:`flash_attention.route` picks (``wgmma``, ``decode`` or
    ``simt``), counted in ``routes("flash_attention")``."""
    _check_flash(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return ref.ref_flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, q_chunk=q_chunk)
    err, out, on = _fa.launch(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    _launched("flash_attention", err)
    _ROUTES["flash_attention"][on] += 1
    return out
