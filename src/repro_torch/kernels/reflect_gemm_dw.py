"""reflect_gemm_dw on the card: dW = R(x)ᵀ·G, the weight's cotangent (R
ETHER+'s H⁺ when v is given).

The CUDA counterpart of ``reflect_gemm_dw_pallas``
(src/repro/kernels/gemm_bwd.py:213).  The kernel source and its design
note are in ``csrc/reflect_gemm_dw.cu``; the plain version is
:func:`repro_torch.kernels.ref.ref_reflect_gemm_dw`.  Callers go through
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
_ARGTYPES = (_P,) * 6 + (_I,) * 6 + (_P,)


def launch(x: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
           v: Optional[torch.Tensor] = None):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    u (n, db) f32, g (T, f), and for ETHER+'s H⁺ v (n, db) f32,
    contiguous on one device.  Returns (cudaError_t, dw) with dw (d, f)
    in x's dtype."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, u, g, v)
    t, d = x.shape
    f = g.shape[1]
    n, db = u.shape
    fn = build.function("reflect_gemm_dw", "reflect_gemm_dw", _ARGTYPES)
    dw = torch.empty((d, f), dtype=x.dtype, device=x.device)
    # f32 scratch: p (t, n) block projections and unorm (n,) norms, then
    # q and vnorm for v
    scratch = torch.empty(((1 if v is None else 2) * (t + 1) * n,),
                          dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), u.data_ptr(), None if v is None else v.data_ptr(),
             g.data_ptr(), scratch.data_ptr(), dw.data_ptr(), t, d, f, n, db,
             DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    return err, dw
