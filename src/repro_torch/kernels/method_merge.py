"""delora_merge and hyperadapt_merge on the card: W' = W + (a·s)·b and
W' = diag(r)·W·diag(c), DeLoRA and HyperAdapt adapters absorbed into
their weights.

The CUDA counterparts of ``delora_merge_pallas`` and
``hyperadapt_merge_pallas`` (src/repro/kernels/method_merge.py:36 and
:81).  The kernel source and its design note are in
``csrc/method_merge.cu``; the plain versions are
:func:`repro_torch.kernels.ref.ref_delora_merge` and
``ref_hyperadapt_merge``.  Callers go through
:func:`repro_torch.kernels.ops.delora_merge` and
``ops.hyperadapt_merge``, which check the inputs and count launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int


def _device(w: torch.Tensor):
    return (torch.cuda.device(w.device)
            if w.device.index != torch.cuda.current_device() else None)


def launch_delora(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  s: torch.Tensor):
    """W + (a·s)·b on CUDA tensors already checked by the wrapper: w
    (d, f), a (d, r) f32, b (r, f) f32, s (r,) in w's dtype, contiguous on
    one device.  Returns (cudaError_t, w')."""
    ctx = _device(w)
    if ctx is not None:
        with ctx:
            return launch_delora(w, a, b, s)
    d, f = w.shape
    fn = build.function("method_merge", "delora_merge",
                        (_P,) * 5 + (_I,) * 4 + (_P,))
    out = torch.empty_like(w)
    err = fn(w.data_ptr(), a.data_ptr(), b.data_ptr(), s.data_ptr(),
             out.data_ptr(), d, f, a.shape[1], DTYPE_CODE[w.dtype],
             torch.cuda.current_stream().cuda_stream)
    return err, out


def launch_hyperadapt(w: torch.Tensor, r: torch.Tensor, c: torch.Tensor):
    """diag(r)·w·diag(c) on CUDA tensors already checked by the wrapper:
    w (d, f), r (d,) f32, c (f,) f32, contiguous on one device.  Returns
    (cudaError_t, w')."""
    ctx = _device(w)
    if ctx is not None:
        with ctx:
            return launch_hyperadapt(w, r, c)
    d, f = w.shape
    fn = build.function("method_merge", "hyperadapt_merge",
                        (_P,) * 4 + (_I,) * 3 + (_P,))
    out = torch.empty_like(w)
    err = fn(w.data_ptr(), r.data_ptr(), c.data_ptr(), out.data_ptr(), d, f,
             DTYPE_CODE[w.dtype], torch.cuda.current_stream().cuda_stream)
    return err, out
