"""etherplus_gemm on the card: y = (H⁺x)·W [·H̃⁺], the ETHER+ linear.

The CUDA counterpart of ``etherplus_gemm_pallas``
(src/repro/kernels/etherplus_gemm.py:92).  The kernel source and its
design note are in ``csrc/etherplus_gemm.cu``; the plain version is
:func:`repro_torch.kernels.ref.ref_etherplus_gemm`.  Callers go through
:func:`repro_torch.kernels.ops.etherplus_gemm` (and
``ops.etherplus_gemm_bwd``, whose two-sided backward recomputes the
one-sided product), which check the inputs and count launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 9 + (_I,) * 8 + (_P,)


def launch(x: torch.Tensor, w: torch.Tensor, u1: torch.Tensor,
           v1: torch.Tensor, u2: Optional[torch.Tensor] = None,
           v2: Optional[torch.Tensor] = None):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    w (d, f), u1/v1 (n, db) f32, u2/v2 (n_out, db_out) f32 or None, all
    contiguous on one device.  Returns (cudaError_t, y)."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, w, u1, v1, u2, v2)
    t, d = x.shape
    f = w.shape[1]
    n, db = u1.shape
    n_out, db_out = u2.shape if u2 is not None else (0, 0)
    fn = build.function("etherplus_gemm", "etherplus_gemm", _ARGTYPES)
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    # f32 scratch: p, unorm, q, vnorm of the prologue, then (two-sided) the
    # GEMM's (t, f) f32 result that the epilogue updates
    scratch = torch.empty((2 * (t + 1) * n + (t * f if u2 is not None else 0),),
                          dtype=torch.float32, device=x.device)
    proj = scratch.data_ptr()
    yacc = proj + 4 * 2 * (t + 1) * n if u2 is not None else None
    err = fn(x.data_ptr(), w.data_ptr(), u1.data_ptr(), v1.data_ptr(),
             u2.data_ptr() if u2 is not None else None,
             v2.data_ptr() if v2 is not None else None, proj, yacc,
             y.data_ptr(), t, d, f, n, db, n_out, db_out, DTYPE_CODE[x.dtype],
             torch.cuda.current_stream().cuda_stream)
    return err, y
