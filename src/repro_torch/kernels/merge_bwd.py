"""merge_bwd on the card: the backwards of the weight-side merges, which
weight-mode training (``x @ merge(W, adapter)``) runs.

The CUDA counterparts of ``merge_left_bwd_pallas`` (rank 1 for ETHER's
``ether_merge``, rank 2 through ``_left_rank2_shim`` for ETHER+'s left
factor) and ``merge_right_bwd_pallas`` (ETHER+'s right factor)
(src/repro/kernels/merge_bwd.py:131 and :171).  The kernel source and
its design note are in ``csrc/merge_bwd.cu``; the plain versions are
:func:`repro_torch.kernels.ref.ref_merge_left_bwd` and, for the right
merge (each row of W takes the rank-2 update),
``ref_etherplus_reflect_bwd``.  Callers go through
:func:`repro_torch.kernels.ops.merge_left_bwd` and ``merge_right_bwd``
(or the composition ``etherplus_merge_bwd``), which check the inputs and
count launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 8 + (_I,) * 4 + (_P,)


def _parts(symbol: str, size: int) -> int:
    return build.function("merge_bwd", symbol, (_I,))(size)


def launch_left(w: torch.Tensor, u: torch.Tensor, g: torch.Tensor,
                v: Optional[torch.Tensor], need_dw: bool):
    """(dW, du[, dv]) of W' = H·W (H⁺·W with v) under G, on CUDA tensors
    already checked by the wrapper: w, g (d, f) alike, u[/v] (n, db) f32
    with n·db = d, contiguous on one device.  Returns (cudaError_t, dw or
    None, du[, dv])."""
    if w.device.index != torch.cuda.current_device():
        with torch.cuda.device(w.device):
            return launch_left(w, u, g, v, need_dw)
    n, db = u.shape
    f = w.shape[1]
    dirs = 1 if v is None else 2
    part = torch.empty((dirs * _parts("merge_left_bwd_parts", f) * n * db,),
                       dtype=torch.float32, device=w.device)
    dw = torch.empty_like(w) if need_dw else None
    du = torch.empty_like(u)
    dv = None if v is None else torch.empty_like(v)
    fn = build.function("merge_bwd", "merge_left_bwd", _ARGTYPES)
    err = fn(w.data_ptr(), u.data_ptr(), None if v is None else v.data_ptr(),
             g.data_ptr(), part.data_ptr(),
             None if dw is None else dw.data_ptr(), du.data_ptr(),
             None if dv is None else dv.data_ptr(), f, n, db,
             DTYPE_CODE[w.dtype], torch.cuda.current_stream().cuda_stream)
    return (err, dw, du) if v is None else (err, dw, du, dv)


def launch_right(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor):
    """(dW, du, dv) of W' = W·H̃⁺ under G, on CUDA tensors already checked
    by the wrapper: w, g (d, f) alike, u/v (n_out, db_out) f32 with
    n_out·db_out = f.  Returns (cudaError_t, dw, du, dv)."""
    if w.device.index != torch.cuda.current_device():
        with torch.cuda.device(w.device):
            return launch_right(w, u, v, g)
    d, f = w.shape
    n, db = u.shape
    part = torch.empty((2 * _parts("merge_right_bwd_parts", d) * f,),
                       dtype=torch.float32, device=w.device)
    dw = torch.empty_like(w)
    du, dv = torch.empty_like(u), torch.empty_like(v)
    fn = build.function("merge_bwd", "merge_right_bwd", _ARGTYPES)
    err = fn(w.data_ptr(), u.data_ptr(), v.data_ptr(), g.data_ptr(),
             part.data_ptr(), dw.data_ptr(), du.data_ptr(), dv.data_ptr(), d,
             n, db, DTYPE_CODE[w.dtype],
             torch.cuda.current_stream().cuda_stream)
    return err, dw, du, dv
