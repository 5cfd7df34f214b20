"""etherplus_merge on the card: W' = H⁺_L·W, then W'·H̃⁺_R, an ETHER+
adapter absorbed into its weight.

The CUDA counterparts of ``etherplus_merge_left_pallas`` and
``etherplus_merge_right_pallas`` (src/repro/kernels/etherplus_merge.py:46
and :79).  The kernel source and its design note are in
``csrc/etherplus_merge.cu``; the plain versions are
:func:`repro_torch.kernels.ref.ref_etherplus_merge_left` and
``ref_etherplus_merge_right``.  Callers go through
:func:`repro_torch.kernels.ops.etherplus_merge`, which checks the inputs,
runs left then right and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _P)


def _launch(symbol: str, w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            dim: int):
    if w.device.index != torch.cuda.current_device():
        with torch.cuda.device(w.device):
            return _launch(symbol, w, u, v, dim)
    n, db = u.shape
    fn = build.function("etherplus_merge", symbol, _ARGTYPES)
    out = torch.empty_like(w)
    err = fn(w.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), dim,
             n, db, DTYPE_CODE[w.dtype],
             torch.cuda.current_stream().cuda_stream)
    return err, out


def launch_left(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """H⁺·w on CUDA tensors already checked by the wrapper: w (d, f), u/v
    (n, db) f32 with n·db = d, contiguous on one device.  Returns
    (cudaError_t, w')."""
    return _launch("etherplus_merge_left", w, u, v, w.shape[1])


def launch_right(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """w·H̃⁺ on CUDA tensors already checked by the wrapper: w (d, f), u/v
    (n_out, db_out) f32 with n_out·db_out = f.  Returns (cudaError_t, w')."""
    return _launch("etherplus_merge_right", w, u, v, w.shape[0])
