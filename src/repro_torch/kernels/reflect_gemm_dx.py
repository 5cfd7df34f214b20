"""reflect_gemm_dx on the card: (dx, du) of y = R(x)·W under cotangent G.

The CUDA counterpart of ``reflect_gemm_dx_pallas``
(src/repro/kernels/gemm_bwd.py:118).  The kernel source and its design
note are in ``csrc/reflect_gemm_dx.cu``; the plain version is
:func:`repro_torch.kernels.ref.ref_reflect_gemm_dx`.  Callers go through
:func:`repro_torch.kernels.ops.householder_gemm_bwd`, which checks the
inputs and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def launch(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
           g: torch.Tensor):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    w (d, f), u (n, db) f32, g (T, f), contiguous on one device.
    Returns (cudaError_t, dx, du)."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, w, u, g)
    t, d = x.shape
    f = w.shape[1]
    n, db = u.shape
    tiles = build.function("reflect_gemm_dx", "reflect_gemm_dx_row_tiles",
                           (_I,))(t)
    fn = build.function("reflect_gemm_dx", "reflect_gemm_dx", _ARGTYPES)
    dx = torch.empty_like(x)
    du = torch.empty_like(u)
    # f32 scratch: dXr (t, d), then the per-row-tile ĝ partials (tiles, d)
    scratch = torch.empty(((t + tiles) * d,), dtype=torch.float32,
                          device=x.device)
    dxr = scratch.data_ptr()
    err = fn(x.data_ptr(), w.data_ptr(), u.data_ptr(), g.data_ptr(), dxr,
             dxr + 4 * t * d, dx.data_ptr(), du.data_ptr(), t, d, f, n, db,
             DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    return err, dx, du
