"""ether_reflect and ether_reflect_batched on the card: the standalone
blockwise reflection H_B x, single-tenant and per sequence from a bank.

The CUDA counterparts of ``ether_reflect_pallas``
(src/repro/kernels/ether_reflect.py:35) and
``ether_reflect_batched_pallas``
(src/repro/kernels/ether_reflect_batched.py:44).  The kernel source and
its design note are in ``csrc/ether_reflect.cu``; the plain versions are
:func:`repro_torch.kernels.ref.ref_ether_reflect` and
:func:`~repro_torch.kernels.ref.ref_ether_reflect_batched`.  Callers go
through :func:`repro_torch.kernels.ops.ether_reflect` and
:func:`~repro_torch.kernels.ops.ether_reflect_batched`, which check the
inputs and count launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.batched import _on_device, _stream, _tenants
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, u, out, M, n, db, dtype, stream
_ONE = (_P, _P, _P, _I, _I, _I, _I, _P)
# x, u, ids, ids64, seq, tenants, out, M, n, db, dtype, stream
_BANK = (_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P)


@_on_device
def launch(x: torch.Tensor, u: torch.Tensor):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    u (n, db) f32, contiguous on one device.  Returns (cudaError_t, out)."""
    t, _ = x.shape
    n, db = u.shape
    fn = build.function("ether_reflect", "ether_reflect", _ONE)
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), u.data_ptr(), out.data_ptr(), t, n, db,
             DTYPE_CODE[x.dtype], _stream())
    return err, out


@_on_device
def launch_batched(x: torch.Tensor, u_bank: torch.Tensor, ids: torch.Tensor):
    """R_{ids[b]} x[b]: x (B, S, d), u_bank (A, n, db) f32, ids (B,) int32
    or int64, contiguous on one device.  Returns (cudaError_t, out)."""
    b, s, _ = x.shape
    _, n, db = u_bank.shape
    fn = build.function("ether_reflect", "ether_reflect_batched", _BANK)
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), u_bank.data_ptr(), *_tenants(x, ids, u_bank),
             out.data_ptr(), b * s, n, db, DTYPE_CODE[x.dtype], _stream())
    return err, out
