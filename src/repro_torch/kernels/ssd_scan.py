"""ssd_chunk on the card: the Mamba-2 SSD intra-chunk dual form.

The CUDA counterpart of ``ssd_chunk_pallas``
(src/repro/kernels/ssd_scan.py:52).  The kernel source and its design
note are in ``csrc/ssd_scan.cu``; the plain version, which the CPU takes
and ``chip_smoke.py`` holds the kernel against, is
:func:`repro_torch.kernels.ref.ref_ssd_chunk`.  Callers go through
:func:`repro_torch.kernels.ops.ssd_chunk` (which checks the inputs and
counts launches), as :func:`repro_torch.models.ssm.ssd_chunked` does on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 7 + (_I,) * 8 + (_P,)


def launch(xv: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, chunk: int):
    """Launch on CUDA tensors already checked by the wrapper: xv
    (B, S, H, P) f32, a (B, S, H) f32, b and c (B, S, G, N) f32 or bf16,
    all contiguous on one device, S % chunk == 0.  Returns (cudaError_t,
    y_intra, states, decays)."""
    if xv.device.index != torch.cuda.current_device():
        with torch.cuda.device(xv.device):
            return launch(xv, a, b, c, chunk)
    B, S, H, P = xv.shape
    G, N = b.shape[2], b.shape[3]
    nc = S // chunk
    f32 = torch.float32
    y = torch.empty((B, S, H, P), dtype=f32, device=xv.device)
    states = torch.empty((B, H, nc, N, P), dtype=f32, device=xv.device)
    decays = torch.empty((B, H, nc), dtype=f32, device=xv.device)
    fn = build.function("ssd_scan", "ssd_chunk", _ARGTYPES)
    err = fn(xv.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
             y.data_ptr(), states.data_ptr(), decays.data_ptr(), B, S, H, G,
             N, P, chunk, DTYPE_CODE[b.dtype],
             torch.cuda.current_stream().cuda_stream)
    return err, y, states, decays
