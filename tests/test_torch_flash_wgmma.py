"""The flash kernel's route rule and the arithmetic of its ``wgmma`` and
``decode`` routes, on the CPU.

``wgmma`` scores bf16 q against bf16 k in f32 (the tensor cores' sums of
exact products), scaled to base 2, runs the online softmax over tiles of
128 keys from key 0, rounds P to bf16 for P·V while the row sums add the
f32 P, and rounds the output once.  ``decode`` walks each split of
``decode_splits`` keys in tiles of 64 in f32 (natural exp), writes each
split's (m, l, acc), m = −1e30 and l = 0 where the split saw no key, and
combines the splits in order.  ``_emulate_wgmma`` and ``_emulate_decode``
repeat that arithmetic here, in this file alone; the tests hold them
against the JAX package's ``flash_attention_pallas`` in interpret mode
and ``repro.kernels.ref.ref_flash_attention`` on the same seeded numpy
inputs, the decode route at smollm-360m's (3 query heads a KV head) and
qwen2.5-32b's (5) group shapes cut to two KV heads, with the cursor
mid-cache so that the splits past it are empty.  The CUDA kernel itself
runs on the card (tests/test_torch_cuda_flash.py).  Also the K and V
rows ``chip_smoke.py`` counts in the flash rows' bytes bound."""

import importlib.util
import inspect
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

# bf16: relative Frobenius (P and the output rounded); float32:
# normalised max error (the same f32 math in another order)
BF16_TOL, F32_TOL = 1e-2, 1e-5
WGMMA_KEYS = 128


def _inputs(seed, b, h, hkv, s, t, d, bf16=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, t, d), (b, hkv, t, d))]
    if bf16:
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _valid(qpos, kpos, t, causal, window):
    """(rows, keys) boolean: key kpos visible to the row at qpos."""
    ok = (kpos[None, :] < t) & (kpos[None, :] >= 0)
    ok = ok & torch.ones_like(qpos[:, None], dtype=torch.bool)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def _emulate_wgmma(q, k, v, *, causal=True, window=None, q_offset=0):
    """The wgmma route in float32 on bf16-valued q, k, v (numpy)."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    b, h, s, d = q.shape
    hkv, t = k.shape[1:3]
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    scale2 = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    qpos = q_offset + torch.arange(s)
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros(b, h, s)
    o = torch.zeros(b, h, s, d)
    for k0 in range(0, t, WGMMA_KEYS):
        kt, vt = k[:, :, k0:k0 + WGMMA_KEYS], v[:, :, k0:k0 + WGMMA_KEYS]
        ok = _valid(qpos, k0 + torch.arange(kt.shape[2]), t, causal, window)
        sc = torch.where(ok, (q @ kt.transpose(-1, -2)) * scale2, -math.inf)
        n = torch.maximum(m, sc.amax(-1))
        u = torch.where(n == -math.inf, 0.0, n)
        alpha = torch.exp2(m - u)
        p = torch.exp2(sc - u[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.bfloat16().float() @ vt
        m = n
    return (o / l.clamp_min(1e-30)[..., None]).bfloat16().float().numpy()


def _decode_partials(q, k, v, *, causal=True, window=None, q_offset=0):
    """The decode route's per-split (m, l, acc), float32: m (G, splits,
    rows), l likewise, acc (G, splits, rows, D), G = B·Hkv groups whose
    rows are (query head in the group, s)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1:3]
    rows = s * (h // hkv)
    splits, keys = fa.decode_splits(b, hkv, t)
    qg = q.reshape(b * hkv, rows, d)
    kg, vg = k.reshape(b * hkv, t, d), v.reshape(b * hkv, t, d)
    rpos = q_offset + torch.arange(rows) % s
    kend = min(t, q_offset + s) if causal else t
    kbeg = max(0, q_offset - window + 1) if window is not None else 0
    m = torch.full((b * hkv, splits, rows), -1e30)
    l = torch.zeros(b * hkv, splits, rows)
    acc = torch.zeros(b * hkv, splits, rows, d)
    for i in range(splits):
        lo, hi = max(i * keys, kbeg), min((i + 1) * keys, t, kend)
        if lo >= hi:
            continue
        mi = torch.full((b * hkv, rows), -math.inf)
        li = torch.zeros(b * hkv, rows)
        ai = torch.zeros(b * hkv, rows, d)
        for k0 in range(lo // fa.DECODE_KEYS * fa.DECODE_KEYS, hi,
                        fa.DECODE_KEYS):
            kpos = k0 + torch.arange(fa.DECODE_KEYS)
            inside = (kpos >= lo) & (kpos < hi)
            at = kpos.clamp(max=t - 1)
            kt = torch.where(inside[:, None], kg[:, at], 0.0)
            vt = torch.where(inside[:, None], vg[:, at], 0.0)
            ok = _valid(rpos, kpos, t, causal, window) & inside[None, :]
            sc = torch.where(ok, (qg @ kt.transpose(-1, -2))
                             * (1.0 / math.sqrt(d)), -math.inf)
            n = torch.maximum(mi, sc.amax(-1))
            u = torch.where(n == -math.inf, 0.0, n)
            alpha = torch.exp(mi - u)
            p = torch.exp(sc - u[..., None])
            li = li * alpha + p.sum(-1)
            ai = ai * alpha[..., None] + p @ vt
            mi = n
        m[:, i] = torch.where(li > 0, mi, -1e30)
        l[:, i], acc[:, i] = li, ai
    return m, l, acc


def _emulate_decode(q, k, v, **kw):
    """The decode route (numpy in, numpy out): one split writes its
    output; more are combined in split order."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    m, l, acc = _decode_partials(q, k, v, **kw)
    if m.shape[1] == 1:
        out = acc[:, 0] / l[:, 0].clamp_min(1e-30)[..., None]
    else:
        seen = l > 0
        top = torch.where(seen, m, -math.inf).amax(1, keepdim=True)
        w = torch.where(seen, torch.exp(torch.where(seen, m - top, 0.0)),
                        0.0)
        den = torch.zeros_like(l[:, 0])
        num = torch.zeros_like(acc[:, 0])
        for i in range(m.shape[1]):
            den = den + l[:, i] * w[:, i]
            num = num + acc[:, i] * w[:, i, :, None]
        out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(q.shape).numpy()


def _jax_ref(q, k, v, window=None):
    """The JAX ref, query row i at T − S + i."""
    return np.asarray(jref.ref_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window), np.float32)


def _pallas(q, k, v, window=None, q_offset=0):
    return np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=q_offset, interpret=True), np.float32)


# (B, H, Hkv, S, T, D, window): S = T, and a cached-prefix chunk at
# q_offset = T − S, as the JAX ref places it
WGMMA_SHAPES = [(1, 2, 1, 256, 256, 64, None), (1, 2, 1, 256, 256, 64, 100),
                (1, 2, 1, 128, 384, 128, None)]


@pytest.mark.parametrize("b,h,hkv,s,t,d,window", WGMMA_SHAPES)
def test_emulated_wgmma_route_matches_jax(b, h, hkv, s, t, d, window):
    q, k, v = _inputs(s + t + d, b, h, hkv, s, t, d, bf16=True)
    got = _emulate_wgmma(q, k, v, window=window, q_offset=t - s)
    want = _jax_ref(q, k, v, window)
    assert _frob(got, want) < BF16_TOL
    assert _frob(got, _pallas(q, k, v, window, t - s)) < BF16_TOL


def test_emulated_wgmma_rows_without_keys_are_zeros():
    q, k, v = _inputs(5, 1, 2, 1, 256, 128, 64, bf16=True)
    got = _emulate_wgmma(q, k, v, window=16, q_offset=136)
    want = _pallas(q, k, v, window=16, q_offset=136)
    empty = (want == 0).all(-1)
    assert empty.any() and (got[empty] == 0).all()
    assert _frob(got, want) < BF16_TOL


# (B, H, Hkv, T, cursor): smollm-360m's groups (3 query heads a KV head)
# and qwen2.5-32b's (5), two KV heads, one decode row; the cursors of a
# cache longer than one split sit mid-cache, so later splits are empty
DECODE_SHAPES = [(2, 6, 2, 48, 47), (1, 6, 2, 512, 300),
                 (1, 10, 2, 520, 200), (2, 10, 2, 512, 511)]


@pytest.mark.parametrize("b,h,hkv,t,cursor", DECODE_SHAPES)
def test_emulated_decode_route_matches_jax(b, h, hkv, t, cursor):
    q, k, v = _inputs(t + cursor, b, h, hkv, 1, t, 64)
    got = _emulate_decode(q, k, v, q_offset=cursor)
    # the JAX ref puts the row at T − 1: hand it the cache up to the cursor
    want = _jax_ref(q, k[:, :, :cursor + 1], v[:, :, :cursor + 1])
    assert _max_err(got, want) < F32_TOL
    if b == 1 and t % 128 == 0:
        assert _max_err(got, _pallas(q, k, v, q_offset=cursor)) < F32_TOL


def test_emulated_decode_route_with_a_window_and_several_rows():
    q, k, v = _inputs(9, 1, 8, 2, 4, 700, 32)
    got = _emulate_decode(q, k, v, window=100, q_offset=650)
    want = _jax_ref(q, k[:, :, :654], v[:, :, :654], window=100)
    assert _max_err(got, want) < F32_TOL


@pytest.mark.parametrize("cursor", [0, 130, 300, 519])
def test_splits_come_from_t_and_not_the_cursor(cursor):
    """The split count is a function of (B, Hkv, T): at every cursor the
    same splits, and those that start past the cursor hold m = −1e30,
    l = 0."""
    assert "q_offset" not in inspect.signature(fa.decode_splits).parameters
    b, h, hkv, t = 1, 10, 2, 520
    splits, keys = fa.decode_splits(b, hkv, t)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, b, h, hkv, 1, t, 64))
    m, l, _ = _decode_partials(q, k, v, q_offset=cursor)
    assert m.shape[1] == splits > 1
    past = [i for i in range(splits) if i * keys > cursor]
    assert past or cursor >= (splits - 1) * keys
    for i in range(splits):
        if i in past:
            assert (m[:, i] == -1e30).all() and (l[:, i] == 0).all()
        else:
            assert (l[:, i] > 0).all()


@pytest.mark.parametrize("b,hkv,t,want", [
    (4, 5, 48, (1, 128)), (4, 5, 2064, (7, 320)), (2, 8, 2064, (9, 256)),
    (2, 8, 2048, (8, 256)), (1, 2, 64, (1, 128)), (1, 2, 700, (6, 128)),
    (64, 8, 4096, (1, 4096))])
def test_split_count(b, hkv, t, want):
    splits, keys = fa.decode_splits(b, hkv, t)
    assert (splits, keys) == want
    assert keys % fa.DECODE_KEYS == 0 and splits * keys >= t
    assert (splits - 1) * keys < t


@pytest.mark.parametrize("dtype,d,rows,want", [
    (torch.bfloat16, 128, 2048 * 5, "wgmma"),
    (torch.bfloat16, 64, 32 * 3, "wgmma"),
    (torch.bfloat16, 64, fa.DECODE_ROWS + 1, "wgmma"),
    (torch.bfloat16, 128, fa.DECODE_ROWS, "decode"),
    (torch.bfloat16, 128, 5, "decode"),
    (torch.float32, 64, 3, "decode"),
    (torch.bfloat16, 32, 1, "decode"),
    (torch.float32, 128, 2048 * 5, "simt"),
    (torch.bfloat16, 32, 96, "simt"),
])
def test_route_rule(dtype, d, rows, want):
    assert fa.route(dtype, d, rows) == want


@pytest.fixture(scope="module")
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("s,t,q_offset,window", [
    (2048, 2048, 0, None), (4, 4096, 4000, 1024), (256, 128, 136, 16),
    (1, 2064, 2048, None), (128, 2048, 1920, None), (2000, 2000, 0, 1024),
    (3, 10, 20, 5)])
def test_flash_bound_counts_the_keys_some_row_sees(chip_smoke, s, t,
                                                  q_offset, window):
    cs = chip_smoke
    qpos = q_offset + np.arange(s)[:, None]
    kpos = np.arange(t)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    assert cs.flash_keys(s, t, q_offset, window) == int(mask.any(0).sum())
    assert cs.flash_pairs(s, t, q_offset, window) == int(mask.sum())


@pytest.mark.parametrize("s", [1, 64])
def test_cpu_calls_count_no_launch_and_no_route(s):
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(2, 1, 4, 2, s, 64, 64))
    ops.reset_launches()
    ops.flash_attention(q, k, v, q_offset=64 - s)
    assert set(ops.routes("flash_attention")) == {
        f"flash_attention.{r}" for r in fa.ROUTES}
    assert set(ops.routes("flash_attention").values()) == {0}
    assert ops.launches()["flash_attention"] == 0
    assert set(ops.routes()) == {f"householder_gemm.{r}" for r in
                                 ("wgmma", "wgmma_decode", "simt")}

