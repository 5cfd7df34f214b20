"""reflect_gemm_dx on the card: (dx, du) of y = R(x)·W under cotangent G,
or (dx, du, dv) of ETHER+'s y = (H⁺x)·W.

The CUDA counterpart of ``reflect_gemm_dx_pallas``
(src/repro/kernels/gemm_bwd.py:118).  The kernel source and its design
note are in ``csrc/reflect_gemm_dx.cu``; the plain version is
:func:`repro_torch.kernels.ref.ref_reflect_gemm_dx`.  Callers go through
:func:`repro_torch.kernels.ops.householder_gemm_bwd`, which checks the
inputs and counts launches, and ``ops.etherplus_gemm_bwd`` (rank 2).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 10 + (_I,) * 6 + (_P,)


def launch(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
           g: torch.Tensor, v: Optional[torch.Tensor] = None):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    w (d, f), u (n, db) f32, g (T, f), and for ETHER+'s H⁺ v (n, db) f32,
    contiguous on one device.  Returns (cudaError_t, dx, du), with v
    (cudaError_t, dx, du, dv)."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, w, u, g, v)
    t, d = x.shape
    f = w.shape[1]
    n, db = u.shape
    tiles = build.function("reflect_gemm_dx", "reflect_gemm_dx_row_tiles",
                           (_I,))(t)
    fn = build.function("reflect_gemm_dx", "reflect_gemm_dx", _ARGTYPES)
    rank = 1 if v is None else 2
    dx = torch.empty_like(x)
    du = torch.empty_like(u)
    dv = None if v is None else torch.empty_like(v)
    # f32 scratch: dXr (t, d), then the per-row-tile ĝ partials (tiles, d)
    # of each direction
    scratch = torch.empty(((t + rank * tiles) * d,), dtype=torch.float32,
                          device=x.device)
    dxr = scratch.data_ptr()
    err = fn(x.data_ptr(), w.data_ptr(), u.data_ptr(),
             None if v is None else v.data_ptr(), g.data_ptr(), dxr,
             dxr + 4 * t * d, dx.data_ptr(), du.data_ptr(),
             None if dv is None else dv.data_ptr(), t, d, f, n, db,
             DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    return (err, dx, du) if v is None else (err, dx, du, dv)
