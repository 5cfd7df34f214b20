"""Public wrappers of the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity and raises
:class:`KernelInputError`, naming the shapes and dtypes it refuses, on
anything its kernel does not take.  On CUDA tensors it launches the
kernel and raises :class:`KernelLaunchError` if the launch is refused;
on CPU tensors, and only there, it computes the kernel's plain version.
There is no fallback from a CUDA tensor to the plain version.

``launches()`` counts launches per kernel (plain-version calls are not
launches; ``householder_gemm_bwd`` launches ``reflect_gemm_dx``, and
``reflect_gemm_dw`` only when asked for dW), so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ether_merge as _merge
from repro_torch.kernels import householder_gemm as _hh
from repro_torch.kernels import ref
from repro_torch.kernels import reflect_gemm_dw as _dw
from repro_torch.kernels import reflect_gemm_dx as _dx

_LAUNCHES = {"householder_gemm": 0, "ether_merge": 0, "reflect_gemm_dx": 0,
             "reflect_gemm_dw": 0}
_F32 = torch.float32


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
    (run only once the wrapper's one-expression check has failed)."""
    w, u = tensors["w"], tensors["u"]
    if main.dtype not in _hh.DTYPE_CODE:
        why = "the kernel takes float32 or bfloat16 activations and weights"
    elif u.dtype != _F32 or u.dim() != 2:
        why = "u must be a float32 (n, db) tensor"
    elif w.dim() != 2 or w.dtype != main.dtype:
        why = "w must be a (d, f) matrix in the activations' dtype"
    elif not w.shape[0] == u.shape[0] * u.shape[1] == main_d:
        why = "need x (..., d), w (d, f) and u (n, db) with n·db = d"
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
