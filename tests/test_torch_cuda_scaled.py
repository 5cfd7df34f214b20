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
