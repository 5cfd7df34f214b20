"""ether_merge on the card: W' = H_B·W, an ETHER adapter absorbed into
its weight.

The CUDA counterpart of ``ether_merge_pallas``
(src/repro/kernels/ether_merge.py:29).  The kernel source and its design
note are in ``csrc/ether_merge.cu``; the plain version is
:func:`repro_torch.kernels.ref.ref_ether_merge`.  Callers go through
:func:`repro_torch.kernels.ops.ether_merge`, which checks the inputs and
counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _P)


def launch(w: torch.Tensor, u: torch.Tensor):
    """Launch on CUDA tensors already checked by the wrapper: w (d, f),
    u (n, db) f32, contiguous on one device.  Returns (cudaError_t, w')."""
    if w.device.index != torch.cuda.current_device():
        with torch.cuda.device(w.device):
            return launch(w, u)
    f = w.shape[1]
    n, db = u.shape
    fn = build.function("ether_merge", "ether_merge", _ARGTYPES)
    out = torch.empty_like(w)
    err = fn(w.data_ptr(), u.data_ptr(), out.data_ptr(), f, n, db,
             DTYPE_CODE[w.dtype], torch.cuda.current_stream().cuda_stream)
    return err, out
