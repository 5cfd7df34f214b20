"""etherplus_gemm on the card: y = (H⁺x)·W [·H̃⁺], the ETHER+ linear.

The CUDA counterpart of ``etherplus_gemm_pallas``
(src/repro/kernels/etherplus_gemm.py:92).  The kernel source and its
design note are in ``csrc/etherplus_gemm.cu`` (its wgmma route on the
core of ``csrc/hh_wgmma.cuh``, which row 1's ``householder_gemm`` and the
bank's forward share); the plain version is
:func:`repro_torch.kernels.ref.ref_etherplus_gemm`.  Callers go through
:func:`repro_torch.kernels.ops.etherplus_gemm` (and
``ops.etherplus_gemm_bwd``, whose two-sided backward recomputes the
one-sided product), which check the inputs and count launches and routes
(``ops.routes("etherplus_gemm")``).

Two routes (:func:`route`), each a projection prologue and one GEMM:

``wgmma``
    bf16, n ≤ ``WGMMA_MAX_BLOCKS``, d and f multiples of 8, x, W, u1 and
    v1 16-byte aligned: TMA-fed wgmma,
    y0 = x·W − P·U + Q·V in f32 with U and V summed from the W tiles in
    shared memory.  One-sided y0 is rounded once; two-sided, H̃⁺ runs on
    the f32 accumulators of column tiles holding whole output blocks
    (:func:`epilogue` ``fused``, :func:`column_tiles`) or, where such
    tiles would hold too little, on an f32 scratch (``scratch``).
``simt``
    the shared register-tiled f32 SIMT GEMM: float32, n > 32, widths not
    multiples of 8, misaligned views.

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
from repro_torch.kernels import reflect_gemm_dx as _dx
from repro_torch.kernels.householder_gemm import DTYPE_CODE, wgmma_takes

ROUTES = ("wgmma", "simt")
ROUTE_CODE = {"simt": 0, "wgmma": 1}
# the fused epilogue's column tiles, and the least share of one that its
# whole output blocks must fill, else the scratch epilogue
# (tools/ep_epilogues.py on the H100: tiles of 15/16 ran 1.05-1.20x the
# scratch epilogue's speed at a train step's 1,024 rows, to 1.22x at
# 2,048; a tile of one 80-wide block, 5/8 of it, 1.00x and 0.83x; PERF.md)
TILE, FUSED_FILL = 128, 0.75
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, u1, v1, u2, v2, scratch, yacc, y, M, K, N, n, db, n_out, db_out,
# dtype, route, nb, stream
_ARGTYPES = (_P,) * 9 + (_I,) * 10 + (_P,)


def route(dtype: torch.dtype, d: int, f: int, n: int, aligned: bool) -> str:
    """The route of a call on x (·, d) and w (d, f) of ``dtype`` with n
    input blocks, at every row count; ``aligned``: x, w, u1 and v1 start
    on 16 bytes."""
    return "wgmma" if wgmma_takes(dtype, d, f, n, aligned) else "simt"


@functools.cache
def tile_blocks(n_out: int, db_out: int) -> int:
    """The whole output blocks a ``TILE``-column tile can hold, at most
    ``reflect_gemm_dx.MAX_BLOCKS``, cut back until the tiles start on a
    multiple of 8 columns (W's TMA boxes start at a tile's first column,
    which must lie on 16 bytes) unless one tile holds them all; 0 where
    no block fits."""
    nb = min(n_out, TILE // db_out, _dx.MAX_BLOCKS)
    while 0 < nb < n_out and nb * db_out % 8:
        nb -= 1
    return nb


@functools.cache
def blocks_per_tile(n_out: int, db_out: int) -> int:
    """:func:`tile_blocks` where they fill at least ``FUSED_FILL`` of a
    tile or all fit one (the fused epilogue), else 0 (the scratch one)."""
    nb = tile_blocks(n_out, db_out)
    return nb if nb == n_out or nb * db_out >= FUSED_FILL * TILE else 0


def column_tiles(n_out: int, db_out: int) -> list[tuple[int, int]]:
    """(first column, columns kept) of each fused column tile: whole
    output blocks from a block boundary on a multiple of 8 columns."""
    nb = blocks_per_tile(n_out, db_out)
    return [(i * db_out, min(nb, n_out - i) * db_out)
            for i in range(0, n_out, nb)]


def epilogue(n_out: Optional[int], db_out: Optional[int]) -> str:
    """The wgmma route's epilogue: ``none`` one-sided (n_out None),
    ``fused`` where a column tile holds whole output blocks of db_out,
    else ``scratch``."""
    if n_out is None:
        return "none"
    return "fused" if blocks_per_tile(n_out, db_out) else "scratch"


def map_counts() -> dict[str, int]:
    """The wgmma route's tensor-map cache (:func:`build.map_counts`): two
    lookups a call."""
    return build.map_counts("etherplus_gemm", "ep_map_counts")


def launch(x: torch.Tensor, w: torch.Tensor, u1: torch.Tensor,
           v1: torch.Tensor, u2: Optional[torch.Tensor] = None,
           v2: Optional[torch.Tensor] = None, on: Optional[str] = None,
           epi: Optional[str] = None):
    """Launch on CUDA tensors already checked by the wrapper: x (T, d),
    w (d, f), u1/v1 (n, db) f32, u2/v2 (n_out, db_out) f32 or None, all
    contiguous on one device, on route ``on`` (:func:`route`'s when
    None); ``epi`` forces the two-sided wgmma route's epilogue (``fused``
    on :func:`tile_blocks`' tiles, or ``scratch``; :func:`epilogue`'s
    when None).  Returns (cudaError_t, y, the route taken)."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return launch(x, w, u1, v1, u2, v2, on, epi)
    t, d = x.shape
    f = w.shape[1]
    n, db = u1.shape
    n_out, db_out = u2.shape if u2 is not None else (0, 0)
    xp, wp, up, vp = x.data_ptr(), w.data_ptr(), u1.data_ptr(), v1.data_ptr()
    if on is None:
        on = route(x.dtype, d, f, n, not (xp | wp | up | vp) & 15)
    nb = 0
    if on == "wgmma" and u2 is not None and epi != "scratch":
        nb = (tile_blocks if epi == "fused" else blocks_per_tile)(n_out,
                                                                  db_out)
    fn = build.function("etherplus_gemm", "etherplus_gemm", _ARGTYPES)
    y = torch.empty((t, f), dtype=x.dtype, device=dev)
    # f32 scratch: p, unorm, q, vnorm of the prologue, then (two-sided,
    # but for the fused epilogue) the GEMM's (t, f) f32 y0 that H̃⁺ updates
    acc = u2 is not None and not nb
    scratch = torch.empty((2 * (t + 1) * n + (t * f if acc else 0),),
                          dtype=torch.float32, device=dev)
    proj = scratch.data_ptr()
    err = fn(xp, wp, up, vp, u2.data_ptr() if u2 is not None else None,
             v2.data_ptr() if v2 is not None else None, proj,
             proj + 4 * 2 * (t + 1) * n if acc else None, y.data_ptr(), t, d,
             f, n, db, n_out, db_out, DTYPE_CODE[x.dtype], ROUTE_CODE[on], nb,
             _dx.stream(dev))
    return err, y, on
