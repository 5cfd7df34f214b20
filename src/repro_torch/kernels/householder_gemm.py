"""householder_gemm on the card: y = R(x)·W, R the blockwise reflection.

The CUDA counterpart of ``householder_gemm_pallas``
(src/repro/kernels/householder_gemm.py:51).  The kernel source and its
design note are in ``csrc/householder_gemm.cu``; the plain version,
which the CPU takes and ``chip_smoke.py`` holds the kernel against, is
:func:`repro_torch.kernels.ref.ref_householder_gemm`.  Callers go
through :func:`repro_torch.kernels.ops.householder_gemm`, which checks
the inputs and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def launch(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    w (d, f), u (n, db) f32, all contiguous on one device.  Returns
    (cudaError_t, y)."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, w, u)
    t, d = x.shape
    f = w.shape[1]
    n, db = u.shape
    fn = build.function("householder_gemm", "hh_gemm", _ARGTYPES)
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    # f32 scratch: p (t, n) block projections, then unorm (n,) norms
    scratch = torch.empty(((t + 1) * n,), dtype=torch.float32,
                          device=x.device)
    p = scratch.data_ptr()
    err = fn(x.data_ptr(), w.data_ptr(), u.data_ptr(), p, p + 4 * t * n,
             y.data_ptr(), t, d, f, n, db, DTYPE_CODE[x.dtype],
             torch.cuda.current_stream().cuda_stream)
    return err, y
