"""flash_attention on the card: exact causal (and sliding-window) softmax
attention with an online softmax, GQA without repeating KV.

The CUDA counterpart of ``flash_attention_pallas``
(src/repro/kernels/flash_attention.py:76).  The kernel source and its
design note are in ``csrc/flash_attention.cu``; the plain version, which
the CPU takes and ``chip_smoke.py`` holds the kernel against, is
:func:`repro_torch.kernels.ref.ref_flash_attention`.  Callers go through
:func:`repro_torch.kernels.ops.flash_attention` (which checks the inputs
and counts launches), as ``models/attention.py`` does on the card through
``execute.dispatch("flash_attention", ...)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.batched import _on_device, _stream
from repro_torch.kernels.householder_gemm import DTYPE_CODE

# the head widths the kernel is compiled for
HEAD_DIMS = (32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, out, B, H, Hkv, S, T, D, q_offset, causal, use_window, window,
# dtype, stream
_ARGTYPES = (_P,) * 4 + (_I,) * 11 + (_P,)


@_on_device
def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int], q_offset: int):
    """Launch on CUDA tensors already checked by the wrapper: q (B, H, S,
    D), k and v (B, Hkv, T, D), one dtype, contiguous on one device.
    Returns (cudaError_t, out (B, H, S, D))."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
             hkv, s, t, d, q_offset, int(causal), int(window is not None),
             0 if window is None else window, DTYPE_CODE[q.dtype], _stream())
    return err, out
