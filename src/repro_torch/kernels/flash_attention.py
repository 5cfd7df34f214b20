"""flash_attention on the card: exact causal (and sliding-window) softmax
attention with an online softmax, GQA without repeating KV.

The CUDA counterpart of ``flash_attention_pallas``
(src/repro/kernels/flash_attention.py:76).  The kernel source and its
design note are in ``csrc/flash_attention.cu``; the plain version, which
the CPU takes and ``chip_smoke.py`` holds every route against, is
:func:`repro_torch.kernels.ref.ref_flash_attention`.  Callers go through
:func:`repro_torch.kernels.ops.flash_attention` (which checks the inputs
and counts launches and routes), as ``models/attention.py`` does on the
card through ``execute.dispatch("flash_attention", ...)``.

Three routes (:func:`route`), picked per call from the dtype, D and the
rows S·(H/Hkv) that one KV group's query heads bring:

``wgmma``
    bf16 prefill at D in ``WGMMA_HEAD_DIMS``: TMA-fed wgmma, 128 query
    rows a block, P rounded to bf16 in registers for P·V.
``decode``
    at most ``DECODE_ROWS`` rows a group (every decode step), both dtypes:
    a block holds a KV group's query heads, so K and V are read once a
    group; T is split over :func:`decode_splits` blocks, whose partials a
    second launch combines in a fixed order (one launch where T fits one
    split).
``simt``
    the first port's SIMT kernel: float32 prefill and D = 32.
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
ROUTES = ("wgmma", "decode", "simt")
# the head widths of the wgmma route (a 64-column swizzled box a 64 of D)
WGMMA_HEAD_DIMS = (64, 128)
# the most rows S·(H/Hkv) a KV group may bring to the decode route
DECODE_ROWS = 64
# the decode route's tiles of keys, the fewest tiles a split walks, and
# the SMs whose count the splits of all groups should reach
DECODE_KEYS, SPLIT_MIN_TILES, SMS = 64, 2, 132
_ROUTE_CODE = {"simt": 0, "wgmma": 1, "decode": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, out, scratch, B, H, Hkv, S, T, D, q_offset, causal, use_window,
# window, dtype, route, splits, split_keys, stream
_ARGTYPES = (_P,) * 5 + (_I,) * 14 + (_P,)


def route(dtype: torch.dtype, d: int, rows: int) -> str:
    """The route of a call at head width ``d`` whose KV groups bring
    ``rows`` = S·(H/Hkv) query rows each."""
    if rows <= DECODE_ROWS:
        return "decode"
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def decode_splits(b: int, hkv: int, t: int) -> tuple[int, int]:
    """(splits, keys a split) of the decode route over a cache of ``t``
    keys and ``b``·``hkv`` KV groups: enough splits that the groups'
    blocks reach ``SMS``, each of at least ``SPLIT_MIN_TILES`` tiles of
    ``DECODE_KEYS``.  The cursor (q_offset) plays no part, so one grid
    serves every step over the same cache."""
    tiles = -(-t // DECODE_KEYS)
    want = -(-SMS // (b * hkv))
    per = max(SPLIT_MIN_TILES, -(-tiles // want))
    return -(-tiles // per), per * DECODE_KEYS


def map_counts() -> dict[str, int]:
    """The wgmma route's tensor-map cache (:func:`build.map_counts`):
    three lookups a call (q, k, v), none on the other routes."""
    return build.map_counts("flash_attention", "flash_map_counts")


@_on_device
def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int], q_offset: int):
    """Launch on CUDA tensors already checked by the wrapper: q (B, H, S,
    D), k and v (B, Hkv, T, D), one dtype, contiguous on one device.
    Returns (cudaError_t, out (B, H, S, D), the route taken)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    qp, kp, vp, op = q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()
    on = route(q.dtype, d, s * (h // hkv))
    splits, split_keys, scratch = 1, 0, None
    if on == "decode":
        splits, split_keys = decode_splits(b, hkv, t)
        if splits > 1:
            # per split and row: acc (D f32), then (m, l)
            scratch = torch.empty(b * h * s * splits * (d + 2),
                                  dtype=torch.float32, device=q.device)
    fn = build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(qp, kp, vp, op, None if scratch is None else scratch.data_ptr(),
             b, h, hkv, s, t, d, q_offset, int(causal),
             int(window is not None), 0 if window is None else window,
             DTYPE_CODE[q.dtype], _ROUTE_CODE[on], splits, split_keys,
             _stream())
    return err, out, on
