"""hyperadapt_gemm on the card: y = ((x·r)·W)·c, HyperAdapt's adapted
linear, and (without c, W read transposed) the GEMMs of its backward.

The CUDA counterpart of ``hyperadapt_gemm_pallas``
(src/repro/kernels/hyperadapt_gemm.py:51).  The kernel source and its
design note are in ``csrc/hyperadapt_gemm.cu``; the plain version is
:func:`repro_torch.kernels.ref.ref_hyperadapt_gemm`.  Callers go through
:func:`repro_torch.kernels.ops.hyperadapt_gemm` and
``ops.hyperadapt_gemm_bwd``, which check the inputs and count launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 5 + (_I,) * 5 + (_P,)


def launch(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor,
           c: Optional[torch.Tensor] = None, *, w_t: bool = False):
    """Launch on CUDA tensors already checked by the wrapper: x (T, K),
    r (K,) f32, c (N,) f32 or None (no column scale), all contiguous on
    one device, and w (K, N), or with ``w_t`` the (N, K) matrix read
    transposed in place.  Returns (cudaError_t, y) with y (T, N) in x's
    dtype."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, w, r, c, w_t=w_t)
    t, k = x.shape
    n = w.shape[0] if w_t else w.shape[1]
    fn = build.function("hyperadapt_gemm", "hyperadapt_gemm", _ARGTYPES)
    y = torch.empty((t, n), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), r.data_ptr(),
             None if c is None else c.data_ptr(), y.data_ptr(), t, k, n,
             int(w_t), DTYPE_CODE[x.dtype],
             torch.cuda.current_stream().cuda_stream)
    return err, y
