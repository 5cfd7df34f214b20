"""hyperadapt_gemm on the card: y = ((x·r)·W)·c, HyperAdapt's adapted
linear, and (without c, W read transposed) the GEMMs of its backward.

The CUDA counterpart of ``hyperadapt_gemm_pallas``
(src/repro/kernels/hyperadapt_gemm.py:51).  The kernel source and its
design note are in ``csrc/hyperadapt_gemm.cu``; the plain version is
:func:`repro_torch.kernels.ref.ref_hyperadapt_gemm`.  Callers go through
:func:`repro_torch.kernels.ops.hyperadapt_gemm` and
``ops.hyperadapt_gemm_bwd``, which check the inputs and count launches
and routes (``ops.routes("hyperadapt_gemm")``).

Two routes (:func:`route`): ``wgmma``, ``csrc/scaled_wgmma.cuh``'s core
with one tenant (x⊙r as bf16 hi and lo planes in the kept scratch the
bank's route uses, ``batched._XR``; 64-deep K partials; c in the
epilogue), and ``simt``, the shared SIMT f32 GEMM (float32, widths that
are not multiples of 8, misaligned operands).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import batched as _bk
from repro_torch.kernels import build
from repro_torch.kernels import reflect_gemm_dx as _dx
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, r, c, xr, y, M, K, N, w_t, dtype, route, stream
_ARGTYPES = (_P,) * 6 + (_I,) * 6 + (_P,)


# the bank's rule and routes (:func:`batched.hyperadapt_route`): ``wgmma``
# where the scaled core takes the call, else ``simt``
route = _bk.hyperadapt_route
ROUTES = _bk.HA_ROUTES


def pick(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
         c: Optional[torch.Tensor], w_t: bool = False) -> str:
    """The route of a call on these operands: every one it loads (c may
    be None) must start on 16 bytes."""
    bits = (x.data_ptr() | w.data_ptr() | r.data_ptr()
            | (0 if c is None else c.data_ptr()))
    return route(x.dtype, x.shape[1], w.shape[0] if w_t else w.shape[1],
                 not bits & 15)


def map_counts() -> dict[str, int]:
    """The wgmma route's tensor-map cache (:func:`build.map_counts`): two
    lookups a call."""
    return build.map_counts("hyperadapt_gemm", "ha_map_counts")


def launch(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
           c: Optional[torch.Tensor] = None, *, w_t: bool = False,
           on: Optional[str] = None):
    """Launch on CUDA tensors already checked by the wrapper: x (T, K),
    r (K,) f32, c (N,) f32 or None (no column scale), all contiguous on
    one device, and w (K, N), or with ``w_t`` the (N, K) matrix read
    transposed in place; on route ``on`` (:func:`pick`'s when None).
    Returns (cudaError_t, y, the route taken) with y (T, N) in x's
    dtype."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, w, r, c, w_t=w_t, on=on)
    t, k = x.shape
    n = w.shape[0] if w_t else w.shape[1]
    on = pick(x, w, r, c, w_t) if on is None else on
    fn = build.function("hyperadapt_gemm", "hyperadapt_gemm", _ARGTYPES)
    stream = _dx.stream(x.device)
    y = torch.empty((t, n), dtype=x.dtype, device=x.device)
    xr = _bk.xr_scratch(x, stream).data_ptr() if on == "wgmma" else None
    err = fn(x.data_ptr(), w.data_ptr(), r.data_ptr(),
             None if c is None else c.data_ptr(), xr, y.data_ptr(), t, k, n,
             int(w_t), DTYPE_CODE[x.dtype], int(on == "wgmma"), stream)
    return err, y, on
