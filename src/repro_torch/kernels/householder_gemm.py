"""householder_gemm on the card: y = R(x)·W, R the blockwise reflection.

The CUDA counterpart of ``householder_gemm_pallas``
(src/repro/kernels/householder_gemm.py:51).  The kernel source and its
design note are in ``csrc/householder_gemm.cu``; the plain version,
which the CPU takes and ``chip_smoke.py`` holds every route against, is
:func:`repro_torch.kernels.ref.ref_householder_gemm`.  Callers go
through :func:`repro_torch.kernels.ops.householder_gemm`, which checks
the inputs and counts launches (``ops.launches()``) and routes
(``ops.routes()``).

Three routes (:func:`route`), each a projection prologue and one GEMM
launch, W read once:

``wgmma``
    bf16 with more than ``DECODE_ROWS`` rows: TMA-fed wgmma on 128×128
    tiles, y = x·W − 2·P·U in f32 with U = ÛᵀW summed from the W tiles
    the GEMM brings into shared memory, rounded once.
``wgmma_decode``
    the same kernel and the same sums on 64-column tiles whose stages
    hold at most ``DECODE_ROWS`` rows of x (decode steps), where reading
    W bounds it: narrower tiles put twice the blocks on W, and a deeper
    ring keeps more of it in flight.
``simt``
    the shared register-tiled f32 SIMT GEMM: float32, more than
    ``WGMMA_MAX_BLOCKS`` reflection blocks, widths that are not multiples
    of 8, or a view of x, w or u that is not 16-byte aligned.

The two wgmma routes sum every output in the same order (set by d
alone), so a row's result does not depend on how many rows share its
call; the SIMT route sums in another order.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "wgmma_decode", "simt")
# the most rows the decode route takes (its stages hold 16 rows of x)
DECODE_ROWS = 16
# the most reflection blocks the wgmma routes take (U's partials, 4·n
# columns of f32 a tile column, live in shared memory)
WGMMA_MAX_BLOCKS = 32
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, u, p, unorm, y, M, K, N, n, db, route code, stream
_ARGTYPES = (_P,) * 6 + (_I,) * 6 + (_P,)
_WGMMA_CODE = {"wgmma": 2, "wgmma_decode": 3}


def wgmma_takes(dtype: torch.dtype, d: int, f: int, n: int,
                aligned: bool) -> bool:
    """Whether the wgmma core (``csrc/hh_wgmma.cuh``, which rows 1, 5 and
    6 share) takes x (·, d) and w (d, f) of ``dtype`` with n reflection
    blocks; ``aligned``: the operands it loads start on 16 bytes.  With
    n = 0, whether ``csrc/scaled_wgmma.cuh``'s core (row 13's) takes it."""
    return (dtype == torch.bfloat16 and n <= WGMMA_MAX_BLOCKS
            and not d % 8 and not f % 8 and aligned)


def route(dtype: torch.dtype, t: int, d: int, f: int, n: int,
          aligned: bool) -> str:
    """The route of a call on x (t, d) and w (d, f) of ``dtype`` with n
    reflection blocks; ``aligned``: x, w and u start on 16 bytes."""
    if not wgmma_takes(dtype, d, f, n, aligned):
        return "simt"
    return "wgmma_decode" if t <= DECODE_ROWS else "wgmma"


def map_counts() -> dict[str, int]:
    """The wgmma routes' tensor-map cache (:func:`build.map_counts`): two
    lookups a call."""
    return build.map_counts("householder_gemm", "hh_map_counts")


def launch(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    w (d, f), u (n, db) f32, all contiguous on one device.  Returns
    (cudaError_t, y, the route taken)."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return launch(x, w, u)
    t, d = x.shape
    f = w.shape[1]
    n, db = u.shape
    xp, wp, up = x.data_ptr(), w.data_ptr(), u.data_ptr()
    on = route(x.dtype, t, d, f, n, not (xp | wp | up) & 15)
    fn = build.function("householder_gemm", "hh_gemm", _ARGTYPES)
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    # f32 scratch: p (t, n) block projections, then unorm (n,) norms
    scratch = torch.empty(((t + 1) * n,), dtype=torch.float32,
                          device=x.device)
    p = scratch.data_ptr()
    code = _WGMMA_CODE.get(on)
    err = fn(xp, wp, up, p, p + 4 * t * n, y.data_ptr(), t, d, f,
              n, db, DTYPE_CODE[x.dtype] if code is None else code,
              torch.cuda.current_stream().cuda_stream)
    return err, y, on
