"""reflect_gemm_dx on the card: (dx, du) of y = R(x)·W under cotangent G,
or (dx, du, dv) of ETHER+'s y = (H⁺x)·W.

The CUDA counterpart of ``reflect_gemm_dx_pallas``
(src/repro/kernels/gemm_bwd.py:118).  The kernel source and its design
note are in ``csrc/reflect_gemm_dx.cu`` (its wgmma route in
``csrc/dxr_wgmma.cuh``); the plain version is
:func:`repro_torch.kernels.ref.ref_reflect_gemm_dx`.  Callers go through
:func:`repro_torch.kernels.ops.householder_gemm_bwd`, which checks the
inputs and counts launches (``ops.launches()``) and routes
(``ops.routes("reflect_gemm_dx")``), and ``ops.etherplus_gemm_bwd``
(rank 2).

Two routes (:func:`route`):

``wgmma``
    bf16, d and f multiples of 8, x, W, G, u (and v) 16-byte aligned:
    dXr = G·Wᵀ by TMA-fed wgmma on 128-row tiles, f32 sums over f in an
    order set by f alone.  Where a reflection block fits a tile (db ≤ 160)
    the column tiles hold whole blocks (:func:`column_tiles`)
    and the reflection backward runs in the GEMM's epilogue, so dXr never
    reaches device memory; wider blocks take the same GEMM into an f32
    scratch and the SIMT route's epilogue (:func:`epilogue`).
``simt``
    everything else (float32 among it): the shared register-tiled f32
    SIMT GEMM into the scratch, then the reflection backward kernel.

The route of a call is :func:`route`'s, looked up at each call, so a
caller may replace it (``tools/train_gap.py`` forces ``simt``) or name a
route to :func:`launch`; a route that cannot take the operands makes the
launch fail (``cudaErrorInvalidValue``), never another route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.householder_gemm import DTYPE_CODE

ROUTES = ("wgmma", "simt")
# the wgmma route's tiles: 128 rows (two warpgroups of 64) by 128 columns
# of dXr, or 160 (an m64n128k16 and an m64n32k16 product a step) where
# whole blocks fill more of them (db 80); a fused tile holds at most
# MAX_BLOCKS blocks (their dots live in shared memory)
TILE_ROWS, TILES, MAX_BLOCKS = 128, (128, 160), 16
# rows of a ĝ partial of the SIMT route's and the scratch epilogue's
# reflection backward (reflect_common.cuh, kRowsPerTile)
SCRATCH_ROWS = 32
ROUTE_CODE = {"simt": 0, "wgmma": 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, u, v, g, dxr, part, dx, du, dv, M, K, N, n, db, dtype, route, nb,
# stream
_ARGTYPES = (_P,) * 10 + (_I,) * 8 + (_P,)


def route(dtype: torch.dtype, t: int, d: int, f: int, n: int, db: int,
          aligned: bool) -> str:
    """The route of a call on x (t, d), w (d, f) of ``dtype`` and n
    reflection blocks of db; ``aligned``: x, w, g and the hyperplanes
    start on 16 bytes."""
    if dtype != torch.bfloat16 or d % 8 or f % 8 or not aligned:
        return "simt"
    return "wgmma"


def _fit(n: int, db: int, width: int) -> int:
    return min(n, width // db, MAX_BLOCKS)


@functools.cache
def tile_width(n: int, db: int) -> int:
    """The wgmma route's column tile at n blocks of db: of ``TILES`` the
    one whose whole blocks fill the largest share of it (the narrower on
    a tie); 0 where no block fits the widest, which takes the scratch
    epilogue's 128-column tiles."""
    best, share = 0, 0.0
    for width in TILES:
        nb = _fit(n, db, width)
        if nb and nb * db / width > share:
            best, share = width, nb * db / width
    return best


@functools.cache
def blocks_per_tile(n: int, db: int) -> int:
    """The whole reflection blocks a column tile of the wgmma route holds
    (:func:`tile_width`'s), 0 under the scratch epilogue."""
    width = tile_width(n, db)
    return _fit(n, db, width) if width else 0


def epilogue(n: int, db: int) -> str:
    """``fused`` (the reflection backward on the GEMM's accumulators) or
    ``scratch`` (dXr in f32 to device memory, then the reflection
    backward kernel): the wgmma route's epilogue at block width db."""
    return "fused" if blocks_per_tile(n, db) else "scratch"


def column_tiles(n: int, db: int) -> list[tuple[int, int]]:
    """(first column, columns kept) of each column tile of dXr (n·db
    columns) on the wgmma route: whole blocks, starting on block
    boundaries, under the fused epilogue (the tile's other columns, up to
    :func:`tile_width`, are computed and dropped); 128-column tiles under
    the scratch one."""
    nb, d = blocks_per_tile(n, db), n * db
    if nb:
        return [(i * db, min(nb, n - i) * db) for i in range(0, n, nb)]
    return [(k, min(TILES[0], d - k)) for k in range(0, d, TILES[0])]


def aligned(*tensors: torch.Tensor) -> bool:
    """Every tensor's data starts on 16 bytes."""
    bits = 0
    for t in tensors:
        bits |= t.data_ptr()
    return not bits & 15


def pick(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
         g: torch.Tensor, v: Optional[torch.Tensor] = None) -> str:
    """The route of a call on these operands (x (t, d), w (d, f), u
    (n, db), g (t, f), v like u or None)."""
    n, db = u.shape
    return route(x.dtype, x.shape[0], x.shape[1], w.shape[1], n, db,
                 aligned(x, w, g, u) and (v is None or aligned(v)))


def part_rows(m: int, seq: int, fused: bool) -> int:
    """Rows of ĝ partials a direction for m = B·seq rows: one a row tile
    of each sequence, ``TILE_ROWS`` rows under the fused epilogue, else
    ``SCRATCH_ROWS``."""
    rows = TILE_ROWS if fused else SCRATCH_ROWS
    return m // seq * -(-seq // rows)


def stream(device: torch.device) -> int:
    """``device``'s current CUDA stream as the raw handle PyTorch's own
    extensions read (``torch.cuda.current_stream()`` builds a Stream
    object first, several µs of a host-bound call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
           g: torch.Tensor, v: Optional[torch.Tensor] = None,
           on: Optional[str] = None):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    w (d, f), u (n, db) f32, g (T, f), and for ETHER+'s H⁺ v (n, db) f32,
    contiguous on one device, on route ``on`` (:func:`pick`'s when None).
    Returns (cudaError_t, dx, du), with v (cudaError_t, dx, du, dv)."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(x, w, u, g, v, on)
    t, d = x.shape
    f = w.shape[1]
    n, db = u.shape
    xp, wp, up, gp = x.data_ptr(), w.data_ptr(), u.data_ptr(), g.data_ptr()
    vp = None if v is None else v.data_ptr()
    if on is None:
        on = route(x.dtype, t, d, f, n, db,
                   not (xp | wp | up | gp | (vp or 0)) & 15)
    nb = blocks_per_tile(n, db) if on == "wgmma" else 0
    fn = build.function("reflect_gemm_dx", "reflect_gemm_dx", _ARGTYPES)
    rank = 1 if v is None else 2
    dx = torch.empty_like(x)
    # f32: du (and dv), then the ĝ partials of each direction; dXr (t, d)
    # apart, for the scratch epilogue and the SIMT route only, so that du
    # does not hold it
    part = u.new_empty((rank + rank * part_rows(t, t, nb > 0), n, db))
    dxr = None if nb else u.new_empty((t, d))
    grads = part.data_ptr()
    err = fn(xp, wp, up, vp, gp, None if dxr is None else dxr.data_ptr(),
             grads + 4 * rank * d, dx.data_ptr(), grads,
             None if v is None else grads + 4 * d, t, d, f, n, db,
             DTYPE_CODE[x.dtype], ROUTE_CODE[on], nb, stream(dev))
    return (err, dx, part[0]) if v is None else (err, dx, part[0], part[1])
