"""The bank kernels on the card: multi-tenant adapter banks, each
sequence b of a (B, S, d) batch served (and trained) by tenant ids[b] of
a bank.

The CUDA counterparts of ``householder_gemm_batched_pallas``
(src/repro/kernels/householder_gemm_batched.py:58),
``etherplus_reflect_batched_pallas``
(src/repro/kernels/etherplus_reflect_batched.py:44),
``delora_gemm_batched_pallas`` (src/repro/kernels/delora_gemm.py:129),
``hyperadapt_gemm_batched_pallas`` (src/repro/kernels/hyperadapt_gemm.py:105)
and of the backwards ``householder_gemm_batched_bwd_pallas`` and
``householder_gemm_batched_dw_pallas`` (src/repro/kernels/gemm_bwd.py:303,
:383) and ``etherplus_reflect_batched_bwd_pallas``
(src/repro/kernels/reflect_bwd_batched.py:118).  The sources and their
design notes are ``csrc/<name>.cu``; the plain versions are
``repro_torch.kernels.ref.ref_<name>``.  Callers go through the checked
wrappers of :mod:`repro_torch.kernels.ops`, which count launches.  Each
launcher takes CUDA tensors already checked there: x (B, S, d)
contiguous, ids (B,) int32 or int64 on x's device, which the kernels read
on the device (mapping an id outside [0, A) into it as the JAX package's
gather maps an index), so no launcher looks at the ids' values on the
host.  Each returns (cudaError_t, out...) with out (B, S, ·) in x's
dtype; the backwards also return their per-sequence ĝ (B, n, db) f32 and
the bank's (A, n, db) f32 gradients.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import householder_gemm as hh
from repro_torch.kernels import reflect_gemm_dx as _dx
from repro_torch.kernels.householder_gemm import DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, u, ids, ids64, seq, tenants, p, unorm, y, M, K, N, n, db, dtype,
# route, stream
_HH = (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P) + (_I,) * 7 + (_P,)
# householder_gemm_batched's routes (:func:`gemm_route`) and the wgmma
# route's rows a tile
GEMM_ROUTES = ("wgmma", "simt")
TILE_ROWS = 128
# x, u, v, ids, ids64, seq, tenants, out, M, n, db, dtype, stream
_EP = (_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P)
# x, w, a, b, s, ids, ids64, seq, tenants, h, y, M, K, N, r, w_t, dtype,
# route, stage, staged, stream
_DG = (_P,) * 6 + (_I,) * 3 + (_P, _P) + (_I,) * 8 + (_P, _P)
# delora_gemm_batched's routes (:func:`delora_route`) and the largest rank
# its wgmma route's low-rank epilogue takes (``sw::kMaxRank``)
DL_ROUTES = ("wgmma", "simt")
LOWRANK_MAX_RANK = 64
# x, w, r, c, ids, ids64, seq, tenants, xr, y, M, K, N, w_t, dtype, route,
# stream
_HG = (_P,) * 5 + (_I,) * 3 + (_P, _P) + (_I,) * 6 + (_P,)
# hyperadapt_gemm_batched's routes (:func:`hyperadapt_route`)
HA_ROUTES = ("wgmma", "simt")
# x, w, u, g, ids, ids64, seq, tenants, dxr, part, ghat, dx, du, M, K, N, n,
# db, dtype, route, nb, stream
_HB = (_P,) * 5 + (_I,) * 3 + (_P,) * 5 + (_I,) * 8 + (_P,)
# x, u, g, ids, ids64, seq, tenants, p, unorm, dw, M, K, N, n, db, dtype,
# stream
_HW = (_P,) * 4 + (_I,) * 3 + (_P,) * 3 + (_I,) * 6 + (_P,)
# x, u, v, g, ids, ids64, seq, tenants, part, ghat, dx, du, dv, M, n, db,
# dtype, stream
_EB = (_P,) * 5 + (_I,) * 3 + (_P,) * 5 + (_I,) * 4 + (_P,)


def _tenants(x: torch.Tensor, ids: torch.Tensor, bank: torch.Tensor):
    """The kernels' (ids, ids64, seq, tenants) arguments."""
    return (ids.data_ptr(), int(ids.dtype == torch.int64), x.shape[1],
            bank.shape[0])


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _on_device(fn):
    """Run the launcher with x's card current, as the other launchers do."""
    def launch(x, *args, **kw):
        if x.device.index != torch.cuda.current_device():
            with torch.cuda.device(x.device):
                return fn(x, *args, **kw)
        return fn(x, *args, **kw)
    launch.__doc__ = fn.__doc__
    return launch


def row_tiles(b: int, s: int) -> list[tuple[int, int]]:
    """(first row, rows) of the wgmma route's row tiles on b sequences of
    s rows: ``TILE_ROWS``-row tiles of each sequence's own, the last one
    ragged, so that no tile straddles two sequences (the kernel's
    ``tile_rows``)."""
    return [(i * s + r, min(TILE_ROWS, s - r)) for i in range(b)
            for r in range(0, s, TILE_ROWS)]


def gemm_route(dtype: torch.dtype, d: int, f: int, n: int,
               aligned: bool) -> str:
    """householder_gemm_batched's route for x (·, ·, d) and w (d, f) of
    ``dtype`` and n blocks; ``aligned``: x, w and the bank start on 16
    bytes.  ``wgmma`` where the wgmma core takes the call
    (:func:`householder_gemm.wgmma_takes`), a row tile a sequence's 128
    rows, whatever the rows a sequence: phase 2's BANK_ROWS found it
    faster than ``simt`` on the card at S = 1, 32 and 33 too, where its
    tiles hold 1 to 33 rows, and its BANK_WIDE_DECODE row (B = 64, S = 1,
    every tenant once, W read once a sequence) no slower (PERF.md §6);
    else ``simt``."""
    return "wgmma" if hh.wgmma_takes(dtype, d, f, n, aligned) else "simt"


def pick_gemm(x: torch.Tensor, w: torch.Tensor, u_bank: torch.Tensor) -> str:
    """The route of householder_gemm_batched on these operands."""
    return gemm_route(x.dtype, x.shape[2], w.shape[1], u_bank.shape[1],
                      _dx.aligned(x, w, u_bank))


@_on_device
def householder_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                             u_bank: torch.Tensor, ids: torch.Tensor,
                             on=None):
    """R_{ids[b]}(x[b]) · w: x (B, S, d), w (d, f), u_bank (A, n, db) f32,
    on route ``on`` (:func:`pick_gemm`'s when None).  Returns (cudaError_t,
    y, the route taken)."""
    b, s, d = x.shape
    f = w.shape[1]
    _, n, db = u_bank.shape
    m = b * s
    on = pick_gemm(x, w, u_bank) if on is None else on
    fn = build.function("householder_gemm_batched", "hh_gemm_batched", _HH)
    y = torch.empty((b, s, f), dtype=x.dtype, device=x.device)
    # f32 scratch: p (m, n) block projections, then unorm (m, n) row norms
    scratch = torch.empty((2 * m * n,), dtype=torch.float32, device=x.device)
    p = scratch.data_ptr()
    err = fn(x.data_ptr(), w.data_ptr(), u_bank.data_ptr(),
             *_tenants(x, ids, u_bank), p, p + 4 * m * n, y.data_ptr(), m, d,
             f, n, db, DTYPE_CODE[x.dtype], int(on == "wgmma"),
             _dx.stream(x.device))
    return err, y, on


@_on_device
def etherplus_reflect_batched(x: torch.Tensor, u_bank: torch.Tensor,
                              v_bank: torch.Tensor, ids: torch.Tensor):
    """H⁺_{ids[b]} x[b]: x (B, S, d), u_bank/v_bank (A, n, db) f32."""
    b, s, _ = x.shape
    _, n, db = u_bank.shape
    fn = build.function("etherplus_reflect_batched",
                        "etherplus_reflect_batched", _EP)
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), u_bank.data_ptr(), v_bank.data_ptr(),
             *_tenants(x, ids, u_bank), out.data_ptr(), b * s, n, db,
             DTYPE_CODE[x.dtype], _stream())
    return err, out


def delora_route(dtype: torch.dtype, d: int, f: int, r: int,
                 aligned: bool) -> str:
    """delora_gemm_batched's route for x (·, ·, d), a w of d × f (either
    layout) of ``dtype`` and rank r, at every B and S; ``aligned``: x, w
    and both banks start on 16 bytes.  ``wgmma`` where the scaled core takes the call
    (:func:`householder_gemm.wgmma_takes` with no reflection blocks) and
    its low-rank epilogue takes r (≤ ``LOWRANK_MAX_RANK``), else
    ``simt``.  The rank-r term is per row, so rows need no tile of their
    own sequence."""
    return ("wgmma" if hh.wgmma_takes(dtype, d, f, 0, aligned)
            and r <= LOWRANK_MAX_RANK else "simt")


def delora_map_counts() -> dict[str, int]:
    """delora_gemm_batched's wgmma route's tensor-map cache
    (:func:`build.map_counts`): two lookups a call."""
    return build.map_counts("delora_gemm_batched", "dg_map_counts")


@_on_device
def delora_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                        a_bank: torch.Tensor, b_bank: torch.Tensor,
                        s_bank: torch.Tensor, ids: torch.Tensor,
                        w_t: bool = False, dx: bool = False, on=None,
                        stage: bool = True, staged=None):
    """x[b]·w + ((x[b]·a_t)·s_t)·b_t, t = ids[b]: x (B, S, d), w (d, f)
    (with ``w_t`` the (f, d) matrix read transposed in place), a_bank
    (A, d, r) f32, b_bank (A, r, f) f32, s_bank (A, r) in x's dtype, on
    route ``on`` (:func:`delora_route`'s when None).  With ``dx`` the
    backward's dx = x[b]·wᵀ + ((x[b]·b_tᵀ)·s_t)·a_tᵀ (with ``w_t``): x the
    cotangent (B, S, f), w the forward's (d, f) read transposed and the
    forward's banks as they lie (no transposed copies).  ``stage``
    (wgmma): stage the epilogue's bank tile in shared memory where a
    tile's rows name one tenant (the same bits either way); ``staged``
    (wgmma), an int32 (2,) tensor on x's device: the kernel adds the row
    tiles that staged to [0] and every row tile to [1].  Returns
    (cudaError_t, y, the route taken)."""
    b, s, k = x.shape
    n = w.shape[0] if w_t else w.shape[1]
    r = a_bank.shape[2]
    m = b * s
    bits = x.data_ptr() | w.data_ptr() | a_bank.data_ptr() | b_bank.data_ptr()
    on = delora_route(x.dtype, k, n, r, not bits & 15) if on is None else on
    fn = build.function("delora_gemm_batched", "delora_gemm_batched", _DG)
    stream = _dx.stream(x.device)
    y = torch.empty((b, s, n), dtype=x.dtype, device=x.device)
    h = _scratch(_HS, x, stream, m * r, torch.float32)
    err = fn(x.data_ptr(), w.data_ptr(), a_bank.data_ptr(),
             b_bank.data_ptr(), s_bank.data_ptr(), *_tenants(x, ids, a_bank),
             h.data_ptr(), y.data_ptr(), m, k, n, r, int(w_t) | 2 * int(dx),
             DTYPE_CODE[x.dtype], int(on == "wgmma"), int(stage),
             None if staged is None else staged.data_ptr(), stream)
    return err, y, on


def hyperadapt_route(dtype: torch.dtype, d: int, f: int,
                     aligned: bool) -> str:
    """hyperadapt_gemm_batched's route for x (·, ·, d) and a w of d × f
    (either layout) of ``dtype``, at every B and S; ``aligned``: x, w and
    both banks start on 16 bytes.  ``wgmma`` where the wgmma cores take
    the call (:func:`householder_gemm.wgmma_takes` with no reflection
    blocks: bf16, d and f multiples of 8), else ``simt``.  Its rows need
    no tile of their own sequence: both scales are per row."""
    return "wgmma" if hh.wgmma_takes(dtype, d, f, 0, aligned) else "simt"


def pick_hyperadapt(x: torch.Tensor, w: torch.Tensor, r_bank: torch.Tensor,
                    c_bank, w_t: bool = False) -> str:
    """The route of hyperadapt_gemm_batched on these operands: every one
    it loads (c_bank may be None) must start on 16 bytes."""
    bits = (x.data_ptr() | w.data_ptr() | r_bank.data_ptr()
            | (0 if c_bank is None else c_bank.data_ptr()))
    return hyperadapt_route(x.dtype, x.shape[2],
                            w.shape[0] if w_t else w.shape[1], not bits & 15)


def hyperadapt_map_counts() -> dict[str, int]:
    """hyperadapt_gemm_batched's wgmma route's tensor-map cache
    (:func:`build.map_counts`): two lookups a call."""
    return build.map_counts("hyperadapt_gemm_batched", "hg_map_counts")


# the kept scratches, one buffer a (device, stream) each, grown to the
# largest call: the wgmma routes' bf16 x⊙r as hi and lo planes (the HyperAdapt
# bank's and the single tenant's) and DeLoRA's (M, r) f32 h.  Each call's
# prologue writes its scratch before the next kernel reads it, in stream
# order, and it keeps one address, so no call allocates and the planes'
# tensor maps stay in the map cache
_XR: dict = {}
_HS: dict = {}


def _scratch(store: dict, x: torch.Tensor, stream: int, numel: int,
             dtype: torch.dtype) -> torch.Tensor:
    key = (x.device.index, stream)
    buf = store.get(key)
    if buf is None or buf.numel() < numel:
        buf = store[key] = torch.empty(numel, dtype=dtype, device=x.device)
    return buf


def xr_scratch(x: torch.Tensor, stream: int) -> torch.Tensor:
    """The kept scratch of the wgmma routes' x⊙r planes (hi and lo) on
    ``stream``, at least 2·x.numel() elements of x's dtype."""
    return _scratch(_XR, x, stream, 2 * x.numel(), x.dtype)


@_on_device
def hyperadapt_gemm_batched(x: torch.Tensor, w: torch.Tensor,
                            r_bank: torch.Tensor, c_bank, ids: torch.Tensor,
                            w_t: bool = False, on=None):
    """((x[b]·r_t)·w)·c_t, t = ids[b]: x (B, S, d), w (d, f) (with ``w_t``
    the (f, d) matrix read transposed in place), r_bank (A, d) f32, c_bank
    (A, f) f32 or None (no column scale), on route ``on``
    (:func:`pick_hyperadapt`'s when None).  Returns (cudaError_t, y, the
    route taken)."""
    b, s, d = x.shape
    f = w.shape[0] if w_t else w.shape[1]
    on = pick_hyperadapt(x, w, r_bank, c_bank, w_t) if on is None else on
    fn = build.function("hyperadapt_gemm_batched", "hyperadapt_gemm_batched",
                        _HG)
    stream = _dx.stream(x.device)
    y = torch.empty((b, s, f), dtype=x.dtype, device=x.device)
    xr = xr_scratch(x, stream).data_ptr() if on == "wgmma" else None
    err = fn(x.data_ptr(), w.data_ptr(), r_bank.data_ptr(),
             None if c_bank is None else c_bank.data_ptr(),
             *_tenants(x, ids, r_bank), xr, y.data_ptr(), b * s, d, f,
             int(w_t), DTYPE_CODE[x.dtype], int(on == "wgmma"), stream)
    return err, y, on


def route(dtype: torch.dtype, t: int, d: int, f: int, n: int, db: int,
          aligned: bool) -> str:
    """householder_gemm_batched_bwd's route for t = B·S rows: the dXr
    GEMM does not depend on the tenant, so it is
    :func:`reflect_gemm_dx.route`'s rule (``wgmma`` or ``simt``) and
    core; a fused tile's hyperplanes are its sequence's tenant's."""
    return _dx.route(dtype, t, d, f, n, db, aligned)


def pick_bwd(x: torch.Tensor, w: torch.Tensor, u_bank: torch.Tensor,
             g: torch.Tensor) -> str:
    """The route of householder_gemm_batched_bwd on these operands."""
    b, s, d = x.shape
    _, n, db = u_bank.shape
    return route(x.dtype, b * s, d, w.shape[1], n, db,
                 _dx.aligned(x, w, g, u_bank))


@_on_device
def householder_gemm_batched_bwd(x: torch.Tensor, w: torch.Tensor,
                                 u_bank: torch.Tensor, ids: torch.Tensor,
                                 g: torch.Tensor, on=None):
    """(dx, ĝ_seq, du_bank) of R_{ids[b]}(x[b])·w under g (B, S, f): x
    (B, S, d), w (d, f), u_bank (A, n, db) f32; ĝ_seq (B, n, db) f32.
    On route ``on`` (:func:`pick_bwd`'s when None)."""
    b, s, d = x.shape
    f = w.shape[1]
    _, n, db = u_bank.shape
    m = b * s
    on = pick_bwd(x, w, u_bank, g) if on is None else on
    nb = _dx.blocks_per_tile(n, db) if on == "wgmma" else 0
    fn = build.function("householder_gemm_batched_bwd", "hh_gemm_batched_bwd",
                        _HB)
    dx = torch.empty_like(x)
    du = torch.empty_like(u_bank)
    # f32: ĝ_seq (b, n, db), then the row tiles' ĝ partials; dXr (m, d)
    # apart, for the scratch epilogue and the SIMT route only
    part = u_bank.new_empty((b + _dx.part_rows(m, s, nb > 0), n, db))
    dxr = None if nb else u_bank.new_empty((m, d))
    ghat = part.data_ptr()
    err = fn(x.data_ptr(), w.data_ptr(), u_bank.data_ptr(), g.data_ptr(),
             *_tenants(x, ids, u_bank),
             None if dxr is None else dxr.data_ptr(), ghat + 4 * b * d, ghat,
             dx.data_ptr(), du.data_ptr(), m, d, f, n, db,
             DTYPE_CODE[x.dtype], _dx.ROUTE_CODE[on], nb,
             _dx.stream(x.device))
    return err, dx, part[:b], du


@_on_device
def householder_gemm_batched_dw(x: torch.Tensor, u_bank: torch.Tensor,
                                ids: torch.Tensor, g: torch.Tensor):
    """dW = Σ_b R_{ids[b]}(x[b])ᵀ·g[b]: x (B, S, d), u_bank (A, n, db) f32,
    g (B, S, f); dW (d, f) in x's dtype."""
    b, s, d = x.shape
    f = g.shape[2]
    _, n, db = u_bank.shape
    m = b * s
    fn = build.function("householder_gemm_batched_dw", "hh_gemm_batched_dw",
                        _HW)
    dw = torch.empty((d, f), dtype=x.dtype, device=x.device)
    # f32 scratch: p (m, n) block projections, then unorm (m, n) row norms
    scratch = torch.empty((2 * m * n,), dtype=torch.float32, device=x.device)
    p = scratch.data_ptr()
    err = fn(x.data_ptr(), u_bank.data_ptr(), g.data_ptr(),
             *_tenants(x, ids, u_bank), p, p + 4 * m * n, dw.data_ptr(), m,
             d, f, n, db, DTYPE_CODE[x.dtype], _stream())
    return err, dw


@_on_device
def etherplus_reflect_batched_bwd(x: torch.Tensor, u_bank: torch.Tensor,
                                  v_bank: torch.Tensor, ids: torch.Tensor,
                                  g: torch.Tensor):
    """(dx, ĝu_seq, ĝv_seq, du_bank, dv_bank) of H⁺_{ids[b]} x[b] under g
    (B, S, d): x (B, S, d), u_bank/v_bank (A, n, db) f32; ĝu_seq, ĝv_seq
    (B, n, db) f32."""
    b, s, d = x.shape
    _, n, db = u_bank.shape
    tiles = b * build.function("etherplus_reflect_batched_bwd",
                               "etherplus_reflect_batched_bwd_row_tiles",
                               (_I,))(s)
    fn = build.function("etherplus_reflect_batched_bwd",
                        "etherplus_reflect_batched_bwd", _EB)
    dx = torch.empty_like(x)
    ghat = torch.empty((2, b, n, db), dtype=torch.float32, device=x.device)
    du, dv = torch.empty_like(u_bank), torch.empty_like(v_bank)
    # f32 scratch: the row tiles' ĝu partials (tiles, d), then ĝv's
    part = torch.empty((2 * tiles * d,), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), u_bank.data_ptr(), v_bank.data_ptr(),
             g.data_ptr(), *_tenants(x, ids, u_bank), part.data_ptr(),
             ghat.data_ptr(), dx.data_ptr(), du.data_ptr(), dv.data_ptr(),
             b * s, n, db, DTYPE_CODE[x.dtype], _stream())
    return err, dx, ghat[0], ghat[1], du, dv
