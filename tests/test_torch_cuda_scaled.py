"""The HyperAdapt bank's forward (hyperadapt_gemm_batched, and its
backward's z and y0) on its routes, on the card.

Each route (``wgmma`` on ``csrc/scaled_wgmma.cuh``'s core, ``simt``), by
the rule and forced, against the plain version; the route counts; a
row's result independent of the rows beside it and of their tenants; two
calls bitwise equal; the route's scratch and tensor maps reused from call
to call; and a route that cannot take its operands failing its launch
(the wrapper raising KernelLaunchError) rather than running another
route.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda_scaled.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import batched as kb
from repro_torch.kernels import householder_gemm as hh
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

# normalised max error: float32 sums in another order; bf16 one output
# rounding (2^-8) apart
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (d, f): smollm-360m's linears, a K ragged against the 64-deep K steps
# and an f ragged against the 128-wide tiles
LINEARS = ((960, 960), (960, 320), (960, 2560), (2560, 960), (968, 136))
# the bank: (B, S) of phase 2's BANK_ROWS and BANK_WIDE_DECODE, and a
# ragged S
BANK_ROWS = ((4, 1), (4, 32), (16, 128), (64, 1), (3, 33))
TENANTS = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the H100 (see README.md)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bank(device, b, s, d, f, dtype, seed=0):
    rng = np.random.default_rng([seed, b, s, d, f])
    x = _randn(rng, b, s, d).to(device, dtype)
    w = (_randn(rng, d, f) / d ** .5).to(device, dtype)
    rb = (1 + 0.3 * _randn(rng, TENANTS, d)).to(device)
    cb = (1 + 0.3 * _randn(rng, TENANTS, f)).to(device)
    ids = torch.from_numpy(rng.integers(0, TENANTS, b).astype(np.int32)).to(
        device)
    return x, w, rb, cb, ids


def _max_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def _routed(op, name, count=1):
    return {**dict.fromkeys(ops.routes(op), 0), f"{op}.{name}": count}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f", LINEARS)
@pytest.mark.parametrize("b,s", BANK_ROWS)
def test_hyperadapt_bank_routes_match_the_plain_version(cuda_device, b, s,
                                                        d, f, dtype):
    x, w, rb, cb, ids = _bank(cuda_device, b, s, d, f, dtype)
    want = ref.ref_hyperadapt_gemm_batched(x, w, rb, cb, ids)
    ops.reset_launches()
    y = ops.hyperadapt_gemm_batched(x, w, rb, cb, ids)
    torch.cuda.synchronize()
    assert ops.routes("hyperadapt_gemm_batched") == _routed(
        "hyperadapt_gemm_batched",
        "wgmma" if dtype == torch.bfloat16 else "simt")
    assert _max_err(y, want) < TOL[dtype]
    if dtype == torch.bfloat16:
        for on in kb.HA_ROUTES:
            err, forced, took = kb.hyperadapt_gemm_batched(x, w, rb, cb,
                                                           ids, on=on)
            torch.cuda.synchronize()
            assert err == 0 and took == on
            assert _max_err(forced, want) < TOL[dtype], on


@pytest.mark.parametrize("d,f", LINEARS[:4])
@pytest.mark.parametrize("b,s", ((4, 1), (8, 128)))
def test_hyperadapt_z_and_y0_on_wgmma(cuda_device, b, s, d, f):
    """The bank backward's two GEMMs without a column scale, z = (g⊙c_t)·Wᵀ
    (W read K-major in place) and y0 = (x⊙r_t)·W, on the wgmma route,
    against the plain composition."""
    x, w, rb, cb, ids = _bank(cuda_device, b, s, d, f, torch.bfloat16)
    g = torch.randn(b, s, f, generator=torch.Generator(device=cuda_device)
                    .manual_seed(2), device=cuda_device).bfloat16()
    ops.reset_launches()
    got = ops.hyperadapt_gemm_batched_bwd(x, w, rb, cb, ids, g,
                                          need_dw=False)
    want = ref.ref_hyperadapt_gemm_batched_bwd(x, w, rb, cb, ids, g,
                                               need_dw=False)
    torch.cuda.synchronize()
    assert ops.routes("hyperadapt_gemm_batched") == _routed(
        "hyperadapt_gemm_batched", "wgmma", 2)
    for name, p, q in zip(("dx", "dw", "dr", "dc"), got, want):
        if q is not None:
            assert _max_err(p, q) < TOL[torch.bfloat16], name
    for on in kb.HA_ROUTES:
        err, z, _ = kb.hyperadapt_gemm_batched(g, w, cb, None, ids,
                                               w_t=True, on=on)
        err0, y0, _ = kb.hyperadapt_gemm_batched(x, w, rb, None, ids, on=on)
        torch.cuda.synchronize()
        assert err == 0 and err0 == 0
        assert _max_err(z, ref.ref_hyperadapt_gemm_batched(
            g, w.T, cb, None, ids)) < TOL[torch.bfloat16], on
        assert _max_err(y0, ref.ref_hyperadapt_gemm_batched(
            x, w, rb, None, ids)) < TOL[torch.bfloat16], on


def test_hyperadapt_rows_do_not_depend_on_their_neighbours(cuda_device):
    """A 128-row tile holds rows of many tenants: each sequence's rows
    equal those of a call of that sequence alone, bit for bit, whatever
    the tenants beside it; an id past A and a negative one are mapped as
    the plain version maps them."""
    b, s, d, f = 40, 3, 960, 320
    x, w, rb, cb, _ = _bank(cuda_device, b, s, d, f, torch.bfloat16)
    ids = (torch.arange(b, dtype=torch.int32, device=cuda_device) * 7
           % (TENANTS + 3)) - 1
    y = ops.hyperadapt_gemm_batched(x, w, rb, cb, ids)
    for i in (0, 1, 17, 39):
        alone = ops.hyperadapt_gemm_batched(x[i:i + 1].contiguous(), w, rb,
                                            cb, ids[i:i + 1].contiguous())
        assert torch.equal(alone[0], y[i]), i
    assert _max_err(y, ref.ref_hyperadapt_gemm_batched(x, w, rb, cb, ids)
                    ) < TOL[torch.bfloat16]


def test_hyperadapt_two_calls_are_bitwise_equal(cuda_device):
    x, w, rb, cb, ids = _bank(cuda_device, 8, 128, 2560, 960, torch.bfloat16)
    one = ops.hyperadapt_gemm_batched(x, w, rb, cb, ids)
    two = ops.hyperadapt_gemm_batched(x, w, rb, cb, ids)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


def test_a_route_that_cannot_take_the_operands_is_refused(cuda_device,
                                                          monkeypatch):
    """wgmma named for float32 operands, a width off 16 bytes or a
    misaligned x fails the launch, and the wrapper raises
    KernelLaunchError: no other route runs in its place."""
    xb, wb, rb, cb, ids = _bank(cuda_device, 2, 128, 960, 320, torch.float32)
    assert kb.hyperadapt_gemm_batched(xb, wb, rb, cb, ids, on="wgmma")[0] != 0
    xh, wh, rh, ch, ih = _bank(cuda_device, 2, 16, 964, 320, torch.bfloat16)
    assert kb.hyperadapt_gemm_batched(xh, wh, rh, ch, ih, on="wgmma")[0] != 0
    xm = torch.empty(2 * 16 * 960 + 4, dtype=torch.bfloat16,
                     device=cuda_device)[4:].view(2, 16, 960)
    xm.copy_(xh[..., :960])
    wm = wh[:960].contiguous()
    assert kb.hyperadapt_gemm_batched(xm, wm, rh[:, :960].contiguous(), ch,
                                      ih, on="wgmma")[0] != 0
    monkeypatch.setattr(kb, "hyperadapt_route", lambda *a: "wgmma")
    ops.reset_launches()
    with pytest.raises(ops.KernelLaunchError):
        ops.hyperadapt_gemm_batched(xb, wb, rb, cb, ids)
    assert ops.launches()["hyperadapt_gemm_batched"] == 0


def test_repeated_calls_reuse_the_scratch_and_its_maps(cuda_device):
    """x⊙r's planes live in one scratch a stream: calls at a shape already
    seen, on fresh x, encode no tensor map (two lookups a call)."""
    xb, wb, rb, cb, ids = _bank(cuda_device, 8, 128, 960, 320,
                                torch.bfloat16)
    kb.hyperadapt_gemm_batched(xb, wb, rb, cb, ids)
    kb.hyperadapt_gemm_batched(xb[:4].contiguous(), wb, rb, cb, ids[:4])
    torch.cuda.synchronize()
    before = kb.hyperadapt_map_counts()
    for _ in range(3):
        for b in (8, 4):
            kb.hyperadapt_gemm_batched(xb[:b].clone(), wb, rb, cb, ids[:b])
    torch.cuda.synchronize()
    after = kb.hyperadapt_map_counts()
    assert after["lookups"] == before["lookups"] + 12
    assert after["encodes"] == before["encodes"]


def test_the_libraries_keep_their_own_map_caches(cuda_device):
    """The scaled core's library and householder_gemm's each encode their
    own maps and count their own lookups (two a wgmma call)."""
    x = torch.randn(64, 960, device=cuda_device).bfloat16()
    w = (torch.randn(960, 320, device=cuda_device) / 31).bfloat16()
    u = torch.randn(8, 120, device=cuda_device)
    xb, wb, rb, cb, ids = _bank(cuda_device, 2, 32, 960, 320,
                                torch.bfloat16)
    before = (hh.map_counts(), kb.hyperadapt_map_counts())
    ops.householder_gemm(x, w, u)
    torch.cuda.synchronize()
    mid = (hh.map_counts(), kb.hyperadapt_map_counts())
    assert mid[0]["lookups"] == before[0]["lookups"] + 2
    assert mid[1] == before[1]
    kb.hyperadapt_gemm_batched(xb, wb, rb, cb, ids, on="wgmma")
    torch.cuda.synchronize()
    after = (hh.map_counts(), kb.hyperadapt_map_counts())
    assert after[0] == mid[0]
    assert after[1]["lookups"] == mid[1]["lookups"] + 2


# ---------------------------------------------------------------------------
# DeLoRA's bank (delora_gemm_batched: one plane of x and the low-rank
# epilogue) and HyperAdapt's single tenant (hyperadapt_gemm) on the core
# ---------------------------------------------------------------------------

RANKS = (8, 64)


def _delora_bank(device, b, s, d, f, r, dtype, seed=0):
    rng = np.random.default_rng([seed, b, s, d, f, r])
    x = _randn(rng, b, s, d).to(device, dtype)
    w = (_randn(rng, d, f) / d ** .5).to(device, dtype)
    ab = _randn(rng, TENANTS, d, r).to(device)
    bb = _randn(rng, TENANTS, r, f).to(device)
    sb = (_randn(rng, TENANTS, r).abs() + 0.1).to(device, dtype)
    ids = torch.from_numpy(rng.integers(0, TENANTS, b).astype(np.int32)).to(
        device)
    return x, w, ab, bb, sb, ids


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f", LINEARS)
@pytest.mark.parametrize("b,s", BANK_ROWS)
def test_delora_bank_routes_match_the_plain_version(cuda_device, b, s, d, f,
                                                    dtype, r):
    x, w, ab, bb, sb, ids = _delora_bank(cuda_device, b, s, d, f, r, dtype)
    want = ref.ref_delora_gemm_batched(x, w, ab, bb, sb, ids)
    ops.reset_launches()
    y = ops.delora_gemm_batched(x, w, ab, bb, sb, ids)
    torch.cuda.synchronize()
    assert ops.routes("delora_gemm_batched") == _routed(
        "delora_gemm_batched",
        "wgmma" if dtype == torch.bfloat16 else "simt")
    assert _max_err(y, want) < TOL[dtype]
    if dtype == torch.bfloat16:
        for on in kb.DL_ROUTES:
            for stage in (True, False):
                err, forced, took = kb.delora_gemm_batched(
                    x, w, ab, bb, sb, ids, on=on, stage=stage)
                torch.cuda.synchronize()
                assert err == 0 and took == on
                assert _max_err(forced, want) < TOL[dtype], on
                if on == "wgmma":
                    assert torch.equal(forced, y), stage


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("d,f", LINEARS[:4])
@pytest.mark.parametrize("b,s", ((4, 1), (8, 128), (4, 100)))
def test_delora_dx_on_both_routes(cuda_device, b, s, d, f, r):
    """The bank backward's dx = G·Wᵀ + ((G·b_tᵀ)·s_t)·a_tᵀ, W read K-major
    in place and both banks where they lie, against the plain
    composition, on the rule's route and each route forced."""
    x, w, ab, bb, sb, ids = _delora_bank(cuda_device, b, s, d, f, r,
                                         torch.bfloat16)
    g = torch.randn(b, s, f, generator=torch.Generator(device=cuda_device)
                    .manual_seed(2), device=cuda_device).bfloat16()
    ops.reset_launches()
    got = ops.delora_gemm_batched_bwd(x, w, ab, bb, sb, ids, g,
                                      need_dw=False)
    want = ref.ref_delora_gemm_batched_bwd(x, w, ab, bb, sb, ids, g,
                                           need_dw=False)
    torch.cuda.synchronize()
    assert ops.routes("delora_gemm_batched") == _routed(
        "delora_gemm_batched", "wgmma")
    for name, p, q in zip(("dx", "dw", "da", "db", "ds"), got, want):
        if q is not None:
            assert _max_err(p, q) < TOL[torch.bfloat16], name
    for on in kb.DL_ROUTES:
        err, dx, _ = kb.delora_gemm_batched(g, w, ab, bb, sb, ids, w_t=True,
                                            dx=True, on=on)
        torch.cuda.synchronize()
        assert err == 0
        assert _max_err(dx, want[0]) < TOL[torch.bfloat16], on


@pytest.mark.parametrize("on", ["wgmma", "simt"])
@pytest.mark.parametrize("b,s,r", ((4, 1, 8), (8, 128, 8), (4, 33, 64)))
def test_delora_dx_reads_the_banks_where_they_lie(cuda_device, b, s, r, on):
    """dx from the banks as they lie is bit for bit dx from their
    transposed copies (the parent's composition): the same values summed
    in the same order."""
    d, f = 960, 320
    x, w, ab, bb, sb, ids = _delora_bank(cuda_device, b, s, d, f, r,
                                         torch.bfloat16)
    g = torch.randn(b, s, f, generator=torch.Generator(device=cuda_device)
                    .manual_seed(3), device=cuda_device).bfloat16()
    err, strided, _ = kb.delora_gemm_batched(g, w, ab, bb, sb, ids,
                                             w_t=True, dx=True, on=on)
    err2, copied, _ = kb.delora_gemm_batched(
        g, w, bb.transpose(1, 2).contiguous(), ab.transpose(1, 2).contiguous(),
        sb, ids, w_t=True, on=on)
    torch.cuda.synchronize()
    assert err == 0 and err2 == 0
    assert torch.equal(strided, copied)


@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("b,s,one,want", (
    (16, 128, False, (16, 16)), (4, 1, False, (0, 1)), (4, 1, True, (1, 1)),
    (4, 33, False, (1, 2)), (4, 33, True, (2, 2))))
def test_delora_epilogue_counts_the_tiles_it_stages(cuda_device, b, s, one,
                                                     want, stage):
    """The kernel's own count of row tiles (16 rows at 16 or fewer, else
    128): a tile stages b_t where its rows name one tenant (``one``: every
    id the same; at 4 × 33 the second tile holds the last sequence's rows
    alone), and none stages with ``stage`` off."""
    x, w, ab, bb, sb, ids = _delora_bank(cuda_device, b, s, 960, 320, 8,
                                         torch.bfloat16)
    ids = (torch.full_like(ids, 2) if one
           else torch.arange(b, dtype=torch.int32, device=cuda_device)
           % TENANTS)
    tiles = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    err, _, _ = kb.delora_gemm_batched(x, w, ab, bb, sb, ids, on="wgmma",
                                       stage=stage, staged=tiles)
    torch.cuda.synchronize()
    assert err == 0
    assert tuple(tiles.tolist()) == (want[0] if stage else 0, want[1])


def test_delora_rows_do_not_depend_on_their_neighbours(cuda_device):
    """A 128-row tile holds rows of many tenants (the epilogue reads each
    row's b_t with __ldg): each sequence's rows equal a call of that
    sequence alone, whose tiles name one tenant (b_t staged), bit for
    bit; an id past A and a negative one are mapped as the plain version
    maps them."""
    b, s, d, f, r = 40, 3, 960, 320, 8
    x, w, ab, bb, sb, _ = _delora_bank(cuda_device, b, s, d, f, r,
                                       torch.bfloat16)
    ids = (torch.arange(b, dtype=torch.int32, device=cuda_device) * 7
           % (TENANTS + 3)) - 1
    y = ops.delora_gemm_batched(x, w, ab, bb, sb, ids)
    for i in (0, 1, 17, 39):
        alone = ops.delora_gemm_batched(x[i:i + 1].contiguous(), w, ab, bb,
                                        sb, ids[i:i + 1].contiguous())
        assert torch.equal(alone[0], y[i]), i
    assert _max_err(y, ref.ref_delora_gemm_batched(x, w, ab, bb, sb, ids)
                    ) < TOL[torch.bfloat16]


def test_delora_two_calls_are_bitwise_equal(cuda_device):
    x, w, ab, bb, sb, ids = _delora_bank(cuda_device, 8, 128, 2560, 960, 8,
                                         torch.bfloat16)
    one = ops.delora_gemm_batched(x, w, ab, bb, sb, ids)
    two = ops.delora_gemm_batched(x, w, ab, bb, sb, ids)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


def test_a_delora_route_that_cannot_take_the_operands_is_refused(
        cuda_device, monkeypatch):
    """wgmma named for float32, a rank past the epilogue's, a width off 16
    bytes or a misaligned x or bank fails the launch (the rule sends a
    misaligned bank to ``simt``); the wrapper raises
    KernelLaunchError and no other route runs in its place."""
    args = _delora_bank(cuda_device, 2, 128, 960, 320, 8, torch.float32)
    assert kb.delora_gemm_batched(*args, on="wgmma")[0] != 0
    wide = _delora_bank(cuda_device, 2, 16, 960, 320, 72, torch.bfloat16)
    assert kb.delora_route(torch.bfloat16, 960, 320, 72, True) == "simt"
    assert kb.delora_gemm_batched(*wide, on="wgmma")[0] != 0
    odd = _delora_bank(cuda_device, 2, 16, 964, 320, 8, torch.bfloat16)
    assert kb.delora_gemm_batched(*odd, on="wgmma")[0] != 0
    x, w, ab, bb, sb, ids = _delora_bank(cuda_device, 2, 16, 960, 320, 8,
                                         torch.bfloat16)
    xm = torch.empty(2 * 16 * 960 + 4, dtype=torch.bfloat16,
                     device=cuda_device)[4:].view(2, 16, 960)
    xm.copy_(x)
    assert kb.delora_gemm_batched(xm, w, ab, bb, sb, ids, on="wgmma")[0] != 0
    bm = torch.empty(bb.numel() + 1, device=cuda_device)[1:].view(bb.shape)
    bm.copy_(bb)
    assert kb.delora_gemm_batched(x, w, ab, bm, sb, ids)[2] == "simt"
    assert kb.delora_gemm_batched(x, w, ab, bm, sb, ids, on="wgmma")[0] != 0
    monkeypatch.setattr(kb, "delora_route", lambda *a: "wgmma")
    ops.reset_launches()
    with pytest.raises(ops.KernelLaunchError):
        ops.delora_gemm_batched(*args)
    assert ops.launches()["delora_gemm_batched"] == 0


def test_delora_repeated_calls_reuse_the_scratch_and_its_maps(cuda_device):
    """h lives in one scratch a stream, and x is the caller's: calls at a
    shape already seen, on the same x, encode no tensor map (two lookups
    a call) and allocate no scratch."""
    x, w, ab, bb, sb, ids = _delora_bank(cuda_device, 8, 128, 960, 320, 8,
                                         torch.bfloat16)
    x4, ids4 = x[:4].contiguous(), ids[:4].contiguous()
    kb.delora_gemm_batched(x, w, ab, bb, sb, ids)
    kb.delora_gemm_batched(x4, w, ab, bb, sb, ids4)
    torch.cuda.synchronize()
    before, scratch = kb.delora_map_counts(), dict(kb._HS)
    for _ in range(3):
        kb.delora_gemm_batched(x, w, ab, bb, sb, ids)
        kb.delora_gemm_batched(x4, w, ab, bb, sb, ids4)
    torch.cuda.synchronize()
    after = kb.delora_map_counts()
    assert after["lookups"] == before["lookups"] + 12
    assert after["encodes"] == before["encodes"]
    assert {k: v.data_ptr() for k, v in kb._HS.items()} == {
        k: v.data_ptr() for k, v in scratch.items()}


# hyperadapt_gemm (one tenant): the rows of phase 2 (T = 4, 128, 2048)
HA_ROWS = (4, 128, 2048)


def _single(device, t, d, f, dtype, seed=0):
    rng = np.random.default_rng([seed, t, d, f])
    x = _randn(rng, t, d).to(device, dtype)
    w = (_randn(rng, d, f) / d ** .5).to(device, dtype)
    r = (1 + 0.3 * _randn(rng, d)).to(device)
    c = (1 + 0.3 * _randn(rng, f)).to(device)
    return x, w, r, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f", LINEARS)
@pytest.mark.parametrize("t", HA_ROWS)
def test_hyperadapt_routes_match_the_plain_version(cuda_device, t, d, f,
                                                   dtype):
    from repro_torch.kernels import hyperadapt_gemm as kh
    x, w, r, c = _single(cuda_device, t, d, f, dtype)
    want = ref.ref_hyperadapt_gemm(x, w, r, c)
    ops.reset_launches()
    y = ops.hyperadapt_gemm(x, w, r, c)
    torch.cuda.synchronize()
    assert ops.routes("hyperadapt_gemm") == _routed(
        "hyperadapt_gemm", "wgmma" if dtype == torch.bfloat16 else "simt")
    assert _max_err(y, want) < TOL[dtype]
    if dtype == torch.bfloat16:
        for on in kh.ROUTES:
            err, forced, took = kh.launch(x, w, r, c, on=on)
            torch.cuda.synchronize()
            assert err == 0 and took == on
            assert _max_err(forced, want) < TOL[dtype], on


@pytest.mark.parametrize("d,f", LINEARS[:4])
@pytest.mark.parametrize("t", (4, 1024))
def test_hyperadapt_z_and_y0_on_wgmma_with_one_tenant(cuda_device, t, d, f):
    from repro_torch.kernels import hyperadapt_gemm as kh
    x, w, r, c = _single(cuda_device, t, d, f, torch.bfloat16)
    g = torch.randn(t, f, generator=torch.Generator(device=cuda_device)
                    .manual_seed(2), device=cuda_device).bfloat16()
    ops.reset_launches()
    got = ops.hyperadapt_gemm_bwd(x, w, r, c, g, need_dw=False)
    want = ref.ref_hyperadapt_gemm_bwd(x, w, r, c, g, need_dw=False)
    torch.cuda.synchronize()
    assert ops.routes("hyperadapt_gemm") == _routed("hyperadapt_gemm",
                                                    "wgmma", 2)
    for name, p, q in zip(("dx", "dw", "dr", "dc"), got, want):
        if q is not None:
            assert _max_err(p, q) < TOL[torch.bfloat16], name
    for on in kh.ROUTES:
        err, z, _ = kh.launch(g, w, c, w_t=True, on=on)
        err0, y0, _ = kh.launch(x, w, r, on=on)
        torch.cuda.synchronize()
        assert err == 0 and err0 == 0
        assert _max_err(z, ref.ref_hyperadapt_gemm(
            g, w.T.contiguous(), c, torch.ones(d, device=cuda_device))
            ) < TOL[torch.bfloat16], on
        assert _max_err(y0, ref.ref_hyperadapt_gemm(
            x, w, r, torch.ones(f, device=cuda_device))
            ) < TOL[torch.bfloat16], on


def test_hyperadapt_single_is_the_bank_of_one(cuda_device):
    """One tenant's route gives a bank call's bits where every id names
    that tenant, and a row's bits do not depend on the rows beside it."""
    x, w, r, c = _single(cuda_device, 256, 960, 320, torch.bfloat16)
    y = ops.hyperadapt_gemm(x, w, r, c)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    bank = ops.hyperadapt_gemm_batched(x.view(2, 128, 960), w, r[None],
                                       c[None], ids)
    part = ops.hyperadapt_gemm(x[:5].contiguous(), w, r, c)
    torch.cuda.synchronize()
    assert torch.equal(y, bank.view(256, 320))
    assert torch.equal(part, y[:5])
    assert torch.equal(ops.hyperadapt_gemm(x, w, r, c), y)


def test_a_hyperadapt_route_that_cannot_take_the_operands_is_refused(
        cuda_device, monkeypatch):
    from repro_torch.kernels import hyperadapt_gemm as kh
    xf, wf, rf, cf = _single(cuda_device, 64, 960, 320, torch.float32)
    assert kh.launch(xf, wf, rf, cf, on="wgmma")[0] != 0
    xo, wo, ro, co = _single(cuda_device, 64, 964, 320, torch.bfloat16)
    assert kh.launch(xo, wo, ro, co, on="wgmma")[0] != 0
    monkeypatch.setattr(kh, "route", lambda *a: "wgmma")
    ops.reset_launches()
    with pytest.raises(ops.KernelLaunchError):
        ops.hyperadapt_gemm(xf, wf, rf, cf)
    assert ops.launches()["hyperadapt_gemm"] == 0


def test_hyperadapt_repeated_calls_reuse_the_scratch_and_its_maps(
        cuda_device):
    """x⊙r's planes live in the bank's scratch a stream: calls at a shape
    already seen, on fresh x, encode no tensor map and allocate none."""
    from repro_torch.kernels import hyperadapt_gemm as kh
    x, w, r, c = _single(cuda_device, 1024, 960, 320, torch.bfloat16)
    ops.hyperadapt_gemm(x, w, r, c)
    ops.hyperadapt_gemm(x[:512].contiguous(), w, r, c)
    torch.cuda.synchronize()
    before, scratch = kh.map_counts(), dict(kb._XR)
    for _ in range(3):
        for t in (1024, 512):
            ops.hyperadapt_gemm(x[:t].clone(), w, r, c)
    torch.cuda.synchronize()
    after = kh.map_counts()
    assert after["lookups"] == before["lookups"] + 12
    assert after["encodes"] == before["encodes"]
    assert {k: v.data_ptr() for k, v in kb._XR.items()} == {
        k: v.data_ptr() for k, v in scratch.items()}
