"""delora_gemm on the card: y = x·W + ((x·a)·s)·b, DeLoRA's adapted
linear, and (W read transposed) the dx of its backward.

The CUDA counterpart of ``delora_gemm_pallas``
(src/repro/kernels/delora_gemm.py:66).  The kernel source and its design
note are in ``csrc/delora_gemm.cu``; the plain version is
:func:`repro_torch.kernels.ref.ref_delora_gemm`.  Callers go through
:func:`repro_torch.kernels.ops.delora_gemm` and
``ops.delora_gemm_bwd``, which check the inputs and count launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

# the largest r the kernel keeps in shared memory (kMaxRank in
# csrc/reflect_common.cuh)
MAX_RANK = 512
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 6 + (_I,) * 6 + (_P,)


def launch(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor, s: torch.Tensor, *, w_t: bool = False):
    """Launch on CUDA tensors already checked by the wrapper: x (T, K),
    a (K, r) f32, b (r, N) f32, s (r,) in x's dtype, all contiguous on one
    device, and w (K, N), or with ``w_t`` the (N, K) matrix read
    transposed in place.  Returns (cudaError_t, y) with y (T, N) in x's
    dtype."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, w, a, b, s, w_t=w_t)
    t, k = x.shape
    n = w.shape[0] if w_t else w.shape[1]
    fn = build.function("delora_gemm", "delora_gemm", _ARGTYPES)
    y = torch.empty((t, n), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
             s.data_ptr(), y.data_ptr(), t, k, n, a.shape[1], int(w_t),
             DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    return err, y
