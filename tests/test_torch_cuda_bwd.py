"""The dXr backwards' routes on the card: ``reflect_gemm_dx`` (rank 1 and
ETHER+'s rank 2) and ``householder_gemm_batched_bwd``.

Each route (``wgmma`` with its fused and its scratch epilogue, ``simt``)
against the plain version, bf16 and float32, at smollm-360m's block
widths and ragged shapes; the bank at S = 1, 100 and 128 with ids outside
[0, A); both tile widths giving db 80 the same bits; a misaligned view on
``simt``; two calls bitwise equal; routes adding up to launches; an exact
zero du for the tenants no id names; a route that cannot take the
operands refused, not replaced.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda_bwd.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import batched as kb
from repro_torch.kernels import ops, ref
from repro_torch.kernels import reflect_gemm_dx as kdx

pytestmark = pytest.mark.cuda

# dx: normalised max error, float32 sums in another order, bf16 one
# output rounding (2^-8) apart; du: relative Frobenius, the same f32 math
# in another order
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DU_TOL = 1e-4
# (t, d, f, n): smollm-360m's linears at the train step's n = 32 (db 30
# on 128-column tiles, db 80 on 160-column ones), gate at serving's n = 8
# (db 120), down at n = 8 (db 320, scratch), a K ragged against the tiles
# (968 = 8 blocks of 121), a block of 150 on a 160-column tile and the
# smoke width (db 3)
SHAPES = ((1024, 960, 960, 32), (1000, 2560, 960, 32), (130, 960, 2560, 8),
          (257, 2560, 960, 8), (67, 968, 136, 8), (50, 1200, 64, 8),
          (40, 96, 256, 32))
# (B, S): decode, a ragged and a whole 128-row sequence
BANKS = ((4, 1), (4, 100), (8, 128))
TENANTS = 64
# ids with a repeat, A − 1 and two outside [0, A)
IDS = [5, 17, 5, TENANTS - 1, 70, -1, 2, 29]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the H100 (see README.md)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(device, t, d, f, n, dtype, tenants=None, seed=0):
    rng = np.random.default_rng(seed + t * d + f + n)
    x = torch.from_numpy(rng.standard_normal((t, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((d, f), np.float32) / d ** .5)
    g = torch.from_numpy(rng.standard_normal((t, f), np.float32))
    shape = (n, d // n) if tenants is None else (tenants, n, d // n)
    u = torch.from_numpy(rng.standard_normal(shape, np.float32))
    v = torch.from_numpy(rng.standard_normal(shape, np.float32))
    return (x.to(device, dtype), w.to(device, dtype), g.to(device, dtype),
            u.to(device), v.to(device))


def _max_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def _frob(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _routed(op, name):
    return {**dict.fromkeys(ops.routes(op), 0), f"{op}.{name}": 1}


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_reflect_gemm_dx_routes_match_the_plain_version(cuda_device, t, d, f,
                                                        n, dtype, rank):
    x, w, g, u, v = _operands(cuda_device, t, d, f, n, dtype)
    v = v if rank == 2 else None
    ops.reset_launches()
    if v is None:
        dx, _, du = ops.householder_gemm_bwd(x, w, u, g, need_dw=False)
        got = (dx, du)
    else:
        dx, _, du, dv, _, _ = ops.etherplus_gemm_bwd(x, w, u, v, None, None,
                                                     g, need_dw=False)
        got = (dx, du, dv)
    want_route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert kdx.route(dtype, t, d, f, n, d // n, True) == want_route
    assert ops.routes("reflect_gemm_dx") == _routed("reflect_gemm_dx",
                                                    want_route)
    want = ref.ref_reflect_gemm_dx(x, w, u, g, v)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[0].shape == x.shape
    assert _max_err(got[0], want[0]) < TOL[dtype]
    assert max(_frob(a, b) for a, b in zip(got[1:], want[1:])) < DU_TOL
    if dtype == torch.bfloat16:
        # the SIMT route, forced, on the same operands
        err, *forced = kdx.launch(x, w, u, g, v, on="simt")
        torch.cuda.synchronize()
        assert err == 0
        assert _max_err(forced[0], want[0]) < TOL[dtype]
        assert max(_frob(a, b) for a, b in zip(forced[1:], want[1:])) \
            < DU_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s", BANKS)
@pytest.mark.parametrize("d,f,n", [(960, 960, 32), (2560, 960, 32),
                                   (2560, 960, 8)])
def test_bank_routes_match_the_plain_version(cuda_device, d, f, n, b, s,
                                             dtype):
    """Ids with a repeat, A − 1 and two outside [0, A) (mapped as the
    forward maps them); the tenants no id names get an exact zero."""
    x, w, g, u, _ = _operands(cuda_device, b * s, d, f, n, dtype, TENANTS)
    x, g = x.view(b, s, d), g.view(b, s, f)
    ids = torch.tensor(IDS[:b], dtype=torch.int64, device=cuda_device)
    ops.reset_launches()
    dx, _, du = ops.householder_gemm_batched_bwd(x, w, u, ids, g,
                                                 need_dw=False)
    want_route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert ops.routes("householder_gemm_batched_bwd") == _routed(
        "householder_gemm_batched_bwd", want_route)
    err, _, ghat, _ = kb.householder_gemm_batched_bwd(x, w, u, ids, g)
    pdx, pgh = ref.ref_householder_gemm_batched_bwd(x, w, u, ids, g)
    torch.cuda.synchronize()
    assert err == 0
    assert _max_err(dx, pdx) < TOL[dtype]
    assert _frob(ghat, pgh) < DU_TOL
    assert _frob(du, ref.bank_grad(u, ids, pgh)) < DU_TOL
    named = set(ref.bank_index(ids, TENANTS).tolist())
    assert named == {min(max(i + TENANTS if i < 0 else i, 0), TENANTS - 1)
                     for i in IDS[:b]}
    for a in range(TENANTS):
        assert (du[a].abs().max().item() == 0) == (a not in named), a
    if dtype == torch.bfloat16:
        err, fdx, fgh, fdu = kb.householder_gemm_batched_bwd(x, w, u, ids, g,
                                                             on="simt")
        torch.cuda.synchronize()
        assert err == 0
        assert _max_err(fdx, pdx) < TOL[dtype]
        assert _frob(fdu, ref.bank_grad(u, ids, pgh)) < DU_TOL


@pytest.mark.parametrize("t", [130, 1024, 2048])
def test_both_tile_widths_give_db80_the_same_bits(cuda_device, monkeypatch,
                                                   t):
    """db 80 runs on 160-column tiles (two blocks a tile); every order of
    summation is set by db alone, so one block a 128-column tile gives
    dx, du, dv and the bank's ĝ and du the same bits."""
    d, f, n = 2560, 960, 32
    assert kdx.tile_width(n, d // n) == 160
    x, w, g, u, v = _operands(cuda_device, t, d, f, n, torch.bfloat16)
    ub = torch.randn(TENANTS, n, d // n, device=cuda_device)
    ids = torch.tensor(IDS[:2], device=cuda_device)
    runs = []
    for nb in (2, 1):               # 160 columns, then 128
        monkeypatch.setattr(kdx, "blocks_per_tile", lambda n, db, nb=nb: nb)
        runs.append((kdx.launch(x, w, u, g), kdx.launch(x, w, u, g, v),
                     kb.householder_gemm_batched_bwd(
                         x.view(2, t // 2, d), w, ub, ids,
                         g.view(2, t // 2, f))))
    torch.cuda.synchronize()
    for wide, narrow in zip(*runs):
        assert wide[0] == narrow[0] == 0
        assert all(torch.equal(a, b) for a, b in zip(wide[1:], narrow[1:]))


def test_a_misaligned_view_takes_simt(cuda_device):
    t, d, f, n = 64, 960, 256, 32
    x, w, g, u, _ = _operands(cuda_device, t, d, f, n, torch.bfloat16)
    buf = torch.empty(t * f + 1, dtype=torch.bfloat16, device=cuda_device)
    gv = buf[1:].view(t, f)       # contiguous, 2 bytes off 16
    gv.copy_(g)
    ops.reset_launches()
    dx, _, du = ops.householder_gemm_bwd(x, w, u, gv, need_dw=False)
    torch.cuda.synchronize()
    assert ops.routes("reflect_gemm_dx") == _routed("reflect_gemm_dx", "simt")
    pdx, pdu = ref.ref_reflect_gemm_dx(x, w, u, g)
    assert _max_err(dx, pdx) < TOL[torch.bfloat16]
    assert _frob(du, pdu) < DU_TOL
    xb = torch.empty(2 * t * d + 1, dtype=torch.bfloat16, device=cuda_device)
    xv = xb[1:].view(2, t, d)
    xv.copy_(torch.cat([x, x]).view(2, t, d))
    ids = torch.tensor([0, 3], device=cuda_device)
    ops.reset_launches()
    ops.householder_gemm_batched_bwd(xv, w, u.expand(4, n, d // n)
                                     .contiguous(), ids,
                                     torch.cat([g, g]).view(2, t, f),
                                     need_dw=False)
    torch.cuda.synchronize()
    assert ops.routes("householder_gemm_batched_bwd") == _routed(
        "householder_gemm_batched_bwd", "simt")


def test_a_route_that_cannot_take_the_operands_is_refused(cuda_device):
    """wgmma named for float32 operands fails the launch: no other route
    runs in its place."""
    x, w, g, u, _ = _operands(cuda_device, 64, 960, 256, 32, torch.float32)
    assert kdx.launch(x, w, u, g, on="wgmma")[0] != 0
    ids = torch.tensor([1], device=cuda_device)
    assert kb.householder_gemm_batched_bwd(
        x.view(1, 64, 960), w, u.expand(2, 32, 30).contiguous(), ids,
        g.view(1, 64, 256), on="wgmma")[0] != 0


@pytest.mark.parametrize("t,d,f,n", SHAPES[:4])
def test_two_calls_are_bitwise_equal(cuda_device, t, d, f, n):
    x, w, g, u, v = _operands(cuda_device, t, d, f, n, torch.bfloat16)
    for vv in (None, v):
        a = kdx.launch(x, w, u, g, vv)
        b = kdx.launch(x, w, u, g, vv)
        torch.cuda.synchronize()
        assert a[0] == b[0] == 0
        assert all(torch.equal(p, q) for p, q in zip(a[1:], b[1:]))
    ids = torch.tensor(IDS[:8], device=cuda_device)
    xb, gb = x[:t // 8 * 8].view(8, -1, d), g[:t // 8 * 8].view(8, -1, f)
    ub = torch.randn(TENANTS, n, d // n, device=cuda_device)
    a = kb.householder_gemm_batched_bwd(xb, w, ub, ids, gb)
    b = kb.householder_gemm_batched_bwd(xb, w, ub, ids, gb)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(a[1:], b[1:]))


def test_routes_add_up_to_launches_and_reset(cuda_device):
    ops.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        x, w, g, u, v = _operands(cuda_device, 40, 96, 256, 32, dtype)
        ops.householder_gemm_bwd(x, w, u, g, need_dw=False)
        ops.etherplus_gemm_bwd(x, w, u, v, None, None, g, need_dw=False)
        ids = torch.tensor([0, 1], device=cuda_device)
        ops.householder_gemm_batched_bwd(
            x.view(2, 20, 96), w, torch.stack([u, v]), ids,
            g.view(2, 20, 256), need_dw=False)
    torch.cuda.synchronize()
    assert ops.routes("reflect_gemm_dx") == {"reflect_gemm_dx.wgmma": 2,
                                             "reflect_gemm_dx.simt": 2}
    assert ops.routes("householder_gemm_batched_bwd") == {
        "householder_gemm_batched_bwd.wgmma": 1,
        "householder_gemm_batched_bwd.simt": 1}
    launches = ops.launches()
    assert launches["reflect_gemm_dx"] == 4
    assert launches["householder_gemm_batched_bwd"] == 2
    ops.reset_launches()
    for op in ("reflect_gemm_dx", "householder_gemm_batched_bwd"):
        assert set(ops.routes(op).values()) == {0}
