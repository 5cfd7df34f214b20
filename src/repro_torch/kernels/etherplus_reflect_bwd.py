"""etherplus_reflect_bwd on the card: (dx, du, dv) of y = H⁺x under a
cotangent G.

The CUDA counterpart of ``etherplus_reflect_bwd_pallas``
(src/repro/kernels/reflect_bwd.py:150).  The kernel source and its
design note are in ``csrc/etherplus_reflect_bwd.cu``; the plain version
is :func:`repro_torch.kernels.ref.ref_etherplus_reflect_bwd`.  Callers go
through :func:`repro_torch.kernels.ops.etherplus_gemm_bwd` (two-sided),
which checks the inputs and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 5 + (_P,)


def launch(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           g: torch.Tensor):
    """Launch on CUDA tensors already checked by the wrapper: x, g (T, d)
    alike, u/v (n, db) f32, contiguous on one device.  Returns
    (cudaError_t, dx, du, dv)."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, u, v, g)
    t, d = x.shape
    n, db = u.shape
    tiles = build.function("etherplus_reflect_bwd",
                           "etherplus_reflect_bwd_row_tiles", (_I,))(t)
    fn = build.function("etherplus_reflect_bwd", "etherplus_reflect_bwd",
                        _ARGTYPES)
    dx = torch.empty_like(x)
    du, dv = torch.empty_like(u), torch.empty_like(v)
    # f32 scratch: the per-row-tile ĝ_u, then ĝ_v partials (tiles, d) each
    part = torch.empty((2 * tiles * d,), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), u.data_ptr(), v.data_ptr(), g.data_ptr(),
             part.data_ptr(), dx.data_ptr(), du.data_ptr(), dv.data_ptr(), t,
             d, n, db, DTYPE_CODE[x.dtype],
             torch.cuda.current_stream().cuda_stream)
    return err, dx, du, dv
