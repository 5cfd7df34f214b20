"""The forwards of ETHER+ (etherplus_gemm) and of the ETHER bank
(householder_gemm_batched) on their routes, on the card.

Each route (``wgmma`` with each of its epilogues, ``simt``) against the
plain version, the route counts, two calls bitwise equal, a row's result
independent of the rows beside it, a bank of one tenant bitwise equal to
``householder_gemm``'s ``wgmma`` route on that tenant's u, and a route
that cannot take its operands failing its launch (the wrapper raising
KernelLaunchError) rather than running another route.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda_ep.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.transforms import resolve_blocks
from repro_torch.kernels import batched as kb
from repro_torch.kernels import etherplus_gemm as ep
from repro_torch.kernels import householder_gemm as hh
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

# normalised max error: float32 sums in another order; bf16 one output
# rounding (2^-8) apart
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (d, f, n): smollm-360m's linears at training's n = 32 (db 30 and 80;
# db_out 30 and 10: fused tiles, 80: scratch) and serving's n = 8 (db_out
# 120, 40: fused; 320: scratch), a K ragged against the 64-deep K steps
# (968 = 8 blocks of 121) with db_out 17 (scratch: 8 blocks do not fit a
# tile, 7 would start the next one off 16 bytes), db_out 13 over 8 blocks
# (one fused tile of 104 columns), and db_out 14 over 20 blocks (tiles of
# 8 blocks, cut back from 9 so that each starts on 16 bytes)
LINEARS = ((960, 960, 32), (960, 320, 32), (960, 2560, 32), (2560, 960, 32),
           (960, 960, 8), (960, 320, 8), (960, 2560, 8), (968, 136, 8),
           (960, 104, 8), (960, 280, 20))
ROWS = (4, 17, 130, 1024)
# the bank: (B, S) of phase 2's BANK_ROWS and a sequence of two row tiles
BANK_ROWS = ((4, 1), (4, 32), (4, 33), (16, 128), (2, 200))
TENANTS, IDS = 8, (5, 1, 5, 7, 0, 2, 1, 3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the H100 (see README.md)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ep_inputs(device, t, d, f, n, dtype, seed=0):
    rng = np.random.default_rng([seed, t, d, f, n])
    n_out = resolve_blocks(n, f)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    x = randn(t, d).to(device, dtype)
    w = (randn(d, f) / d ** .5).to(device, dtype)
    planes = [randn(n, d // n).to(device) for _ in range(2)]
    planes += [randn(n_out, f // n_out).to(device) for _ in range(2)]
    return (x, w, *planes)


def _max_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def _routed(op, name, count=1):
    return {**dict.fromkeys(ops.routes(op), 0), f"{op}.{name}": count}


@pytest.mark.parametrize("two", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f,n", LINEARS)
@pytest.mark.parametrize("t", ROWS)
def test_ep_routes_match_the_plain_version(cuda_device, t, d, f, n, dtype,
                                           two):
    x, w, u1, v1, u2, v2 = _ep_inputs(cuda_device, t, d, f, n, dtype)
    out = (u2, v2) if two else (None, None)
    want = ref.ref_etherplus_gemm(x, w, u1, v1, *out)
    ops.reset_launches()
    y = ops.etherplus_gemm(x, w, u1, v1, *out)
    torch.cuda.synchronize()
    on = ep.route(dtype, d, f, n, True)
    assert on == ("wgmma" if dtype == torch.bfloat16 else "simt")
    assert ops.routes("etherplus_gemm") == _routed("etherplus_gemm", on)
    assert ops.launches()["etherplus_gemm"] == 1
    assert y.dtype == dtype and y.shape == (t, f)
    assert _max_err(y, want) < TOL[dtype]
    for forced in ("wgmma", "simt") if dtype == torch.bfloat16 else ():
        err, y, taken = ep.launch(x, w, u1, v1, *out, on=forced)
        torch.cuda.synchronize()
        assert err == 0 and taken == forced
        assert _max_err(y, want) < TOL[dtype], forced


@pytest.mark.parametrize("d,f,n,epi", [
    (d, f, n, epi) for d, f, n in LINEARS for epi in ("fused", "scratch")
    if epi == "scratch" or ep.tile_blocks(resolve_blocks(n, f),
                                          f // resolve_blocks(n, f))])
@pytest.mark.parametrize("t", [4, 1024])
def test_ep_each_epilogue_forced_matches_the_plain_version(cuda_device, t, d,
                                                          f, n, epi):
    """Either two-sided epilogue of the wgmma route, forced, where it can
    run (fused: a tile holds a whole output block), is the plain version
    within TOL: the epilogue the rule does not pick stays right too."""
    x, w, u1, v1, u2, v2 = _ep_inputs(cuda_device, t, d, f, n,
                                      torch.bfloat16)
    err, y, taken = ep.launch(x, w, u1, v1, u2, v2, on="wgmma", epi=epi)
    torch.cuda.synchronize()
    assert err == 0 and taken == "wgmma"
    assert _max_err(y, ref.ref_etherplus_gemm(x, w, u1, v1, u2, v2)) \
        < TOL[torch.bfloat16]


@pytest.mark.parametrize("d,f,n", LINEARS[:3] + LINEARS[-2:])
def test_ep_rows_do_not_depend_on_the_rows_beside_them(cuda_device, d, f, n):
    """The wgmma route sums every output in one order, set by d: rows of a
    small call equal the same rows of a large one bit for bit, one- and
    two-sided."""
    x, w, u1, v1, u2, v2 = _ep_inputs(cuda_device, 1030, d, f, n,
                                      torch.bfloat16)
    for out in ((None, None), (u2, v2)):
        big = ep.launch(x, w, u1, v1, *out, on="wgmma")[1]
        for lo, hi in ((0, 1), (7, 9), (100, 164), (1000, 1030)):
            err, part, _ = ep.launch(x[lo:hi].contiguous(), w, u1, v1, *out,
                                     on="wgmma")
            assert err == 0 and torch.equal(part, big[lo:hi]), (lo, hi)
    torch.cuda.synchronize()


@pytest.mark.parametrize("t", [4, 1024])
def test_ep_two_calls_are_bitwise_equal(cuda_device, t):
    x, w, u1, v1, u2, v2 = _ep_inputs(cuda_device, t, 960, 2560, 32,
                                      torch.bfloat16)
    for out in ((None, None), (u2, v2)):
        a = ops.etherplus_gemm(x, w, u1, v1, *out)
        b = ops.etherplus_gemm(x, w, u1, v1, *out)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_ep_backward_recomputes_y0_on_the_forward_route(cuda_device):
    """Two-sided, the backward's y0 recompute is a one-sided forward on
    the route its rows take."""
    x, w, u1, v1, u2, v2 = _ep_inputs(cuda_device, 256, 960, 320, 32,
                                      torch.bfloat16)
    g = torch.randn(256, 320, device=cuda_device).bfloat16()
    ops.reset_launches()
    ops.etherplus_gemm_bwd(x, w, u1, v1, u2, v2, g, need_dw=False)
    torch.cuda.synchronize()
    assert ops.routes("etherplus_gemm") == _routed("etherplus_gemm", "wgmma")


def _bank(device, b, s, d, f, n, dtype, seed=0):
    rng = np.random.default_rng([seed, b, s, d, f, n])
    x = torch.from_numpy(rng.standard_normal((b, s, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((d, f), np.float32) / d ** .5)
    u = torch.from_numpy(rng.standard_normal((TENANTS, n, d // n),
                                             np.float32))
    ids = torch.tensor([IDS[i % len(IDS)] for i in range(b)],
                       dtype=torch.int32)
    return x.to(device, dtype), w.to(device, dtype), u.to(device), \
        ids.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f,n", ((960, 2560, 8), (2560, 960, 32),
                                   (968, 136, 8)))
@pytest.mark.parametrize("b,s", BANK_ROWS)
def test_bank_routes_match_the_plain_version(cuda_device, b, s, d, f, n,
                                             dtype):
    x, w, u, ids = _bank(cuda_device, b, s, d, f, n, dtype)
    want = ref.ref_householder_gemm_batched(x, w, u, ids)
    ops.reset_launches()
    y = ops.householder_gemm_batched(x, w, u, ids)
    torch.cuda.synchronize()
    on = kb.gemm_route(dtype, d, f, n, True)
    assert on == ("wgmma" if dtype == torch.bfloat16 else "simt")
    assert ops.routes("householder_gemm_batched") == _routed(
        "householder_gemm_batched", on)
    assert y.shape == (b, s, f) and _max_err(y, want) < TOL[dtype]
    for forced in ("wgmma", "simt") if dtype == torch.bfloat16 else ():
        err, y, taken = kb.householder_gemm_batched(x, w, u, ids, on=forced)
        torch.cuda.synchronize()
        assert err == 0 and taken == forced
        assert _max_err(y, want) < TOL[dtype], forced


@pytest.mark.parametrize("b,s", ((8, 128), (4, 33), (2, 200)))
def test_a_bank_of_one_tenant_is_row_1_bitwise(cuda_device, b, s):
    """Every id naming tenant 3: the bank's wgmma route gives the bits of
    householder_gemm's wgmma route on tenant 3's u, and so does a bank
    whose other rows name other tenants, row for row."""
    d, f, n = 960, 2560, 32
    x, w, u, _ = _bank(cuda_device, b, s, d, f, n, torch.bfloat16)
    one = ops.householder_gemm(x.view(b * s, d), w, u[3]).view(b, s, f)
    ids = torch.full((b,), 3, dtype=torch.int32, device=cuda_device)
    err, y, on = kb.householder_gemm_batched(x, w, u, ids, on="wgmma")
    torch.cuda.synchronize()
    assert err == 0 and on == "wgmma"
    assert torch.equal(y, one)
    mixed = ids.clone()
    mixed[1:] = torch.arange(1, b, device=cuda_device) % 2
    y = kb.householder_gemm_batched(x, w, u, mixed, on="wgmma")[1]
    torch.cuda.synchronize()
    assert torch.equal(y[0], one[0])


def test_bank_two_calls_are_bitwise_equal(cuda_device):
    x, w, u, ids = _bank(cuda_device, 8, 128, 2560, 960, 32, torch.bfloat16)
    a = ops.householder_gemm_batched(x, w, u, ids)
    b = ops.householder_gemm_batched(x, w, u, ids)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_a_route_that_cannot_take_the_operands_is_refused(cuda_device,
                                                          monkeypatch):
    """wgmma named for float32 operands fails the launch, and the wrappers
    raise KernelLaunchError: no other route runs in its place."""
    x, w, u1, v1, u2, v2 = _ep_inputs(cuda_device, 64, 960, 320, 32,
                                      torch.float32)
    assert ep.launch(x, w, u1, v1, u2, v2, on="wgmma")[0] != 0
    xb, wb, ub, ids = _bank(cuda_device, 2, 128, 960, 320, 8, torch.float32)
    assert kb.householder_gemm_batched(xb, wb, ub, ids, on="wgmma")[0] != 0
    monkeypatch.setattr(ep, "route", lambda *a: "wgmma")
    monkeypatch.setattr(kb, "gemm_route", lambda *a: "wgmma")
    ops.reset_launches()
    with pytest.raises(ops.KernelLaunchError):
        ops.etherplus_gemm(x, w, u1, v1, u2, v2)
    with pytest.raises(ops.KernelLaunchError):
        ops.householder_gemm_batched(xb, wb, ub, ids)
    assert ops.launches()["etherplus_gemm"] == 0
    assert ops.launches()["householder_gemm_batched"] == 0


def test_the_libraries_keep_their_own_map_caches(cuda_device):
    """Three libraries include the shared core: each encodes its own maps
    and counts its own lookups (two a wgmma call)."""
    x, w, u1, v1, _, _ = _ep_inputs(cuda_device, 64, 960, 320, 32,
                                    torch.bfloat16)
    before = (ep.map_counts(), hh.map_counts())
    ep.launch(x, w, u1, v1, on="wgmma")
    torch.cuda.synchronize()
    after = (ep.map_counts(), hh.map_counts())
    assert after[0]["lookups"] == before[0]["lookups"] + 2
    assert after[1] == before[1]
