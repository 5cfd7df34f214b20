"""ether_reflect_bwd and ether_reflect_batched_bwd on the card: (dx, du)
of y = H_B x under a cotangent G, and (dx, ĝ_seq, du_bank) of its bank
form.

The CUDA counterparts of ``ether_reflect_bwd_pallas``
(src/repro/kernels/reflect_bwd.py:117) and
``ether_reflect_batched_bwd_pallas``
(src/repro/kernels/reflect_bwd_batched.py:82) with the JAX op's
``_bank_grad``.  The kernel source and its design note are in
``csrc/ether_reflect_bwd.cu``; the plain versions are
:func:`repro_torch.kernels.ref.ref_ether_reflect_bwd` and
:func:`~repro_torch.kernels.ref.ref_ether_reflect_batched_bwd`.  Callers
go through :func:`repro_torch.kernels.ops.ether_reflect_bwd` and
:func:`~repro_torch.kernels.ops.ether_reflect_batched_bwd`, which check
the inputs and count launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.batched import _on_device, _stream, _tenants
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, u, g, part, dx, du, M, n, db, dtype, stream
_ONE = (_P,) * 6 + (_I,) * 4 + (_P,)
# x, u, g, ids, ids64, seq, tenants, part, ghat, dx, du, M, n, db, dtype,
# stream
_BANK = (_P,) * 4 + (_I,) * 3 + (_P,) * 4 + (_I,) * 4 + (_P,)


def _row_tiles(rows: int) -> int:
    return build.function("ether_reflect_bwd", "ether_reflect_bwd_row_tiles",
                          (_I,))(rows)


@_on_device
def launch(x: torch.Tensor, u: torch.Tensor, g: torch.Tensor):
    """Launch on CUDA tensors already checked by the wrapper: x, g (T, d)
    alike, u (n, db) f32, contiguous on one device.  Returns
    (cudaError_t, dx, du)."""
    t, d = x.shape
    n, db = u.shape
    fn = build.function("ether_reflect_bwd", "ether_reflect_bwd", _ONE)
    dx, du = torch.empty_like(x), torch.empty_like(u)
    # f32 scratch: the per-row-tile ĝ partials (tiles, d)
    part = torch.empty((_row_tiles(t) * d,), dtype=torch.float32,
                       device=x.device)
    err = fn(x.data_ptr(), u.data_ptr(), g.data_ptr(), part.data_ptr(),
             dx.data_ptr(), du.data_ptr(), t, n, db, DTYPE_CODE[x.dtype],
             _stream())
    return err, dx, du


@_on_device
def launch_batched(x: torch.Tensor, u_bank: torch.Tensor, ids: torch.Tensor,
                   g: torch.Tensor):
    """(dx, ĝ_seq, du_bank) of R_{ids[b]} x[b] under g (B, S, d): x
    (B, S, d), u_bank (A, n, db) f32, ids (B,) int32 or int64; ĝ_seq
    (B, n, db) f32.  Returns (cudaError_t, dx, ĝ_seq, du_bank)."""
    b, s, d = x.shape
    _, n, db = u_bank.shape
    fn = build.function("ether_reflect_bwd", "ether_reflect_batched_bwd",
                        _BANK)
    dx, du = torch.empty_like(x), torch.empty_like(u_bank)
    ghat = torch.empty((b, n, db), dtype=torch.float32, device=x.device)
    # f32 scratch: each sequence's row tiles' ĝ partials (tiles, d)
    part = torch.empty((b * _row_tiles(s) * d,), dtype=torch.float32,
                       device=x.device)
    err = fn(x.data_ptr(), u_bank.data_ptr(), g.data_ptr(),
             *_tenants(x, ids, u_bank), part.data_ptr(), ghat.data_ptr(),
             dx.data_ptr(), du.data_ptr(), b * s, n, db, DTYPE_CODE[x.dtype],
             _stream())
    return err, dx, ghat, du
