"""householder_gemm's routes on the card, and ``auto`` attention at head
widths the flash kernel refuses.

Each route (``wgmma``, ``wgmma_decode``, ``simt``) against the plain
version on both sides of every threshold of the route rule, its launch
and route counts, its determinism, and that a row's result does not
depend on the rows beside it on the wgmma routes; then the qwen2.5,
deepseek-coder and minicpm smoke configs (heads 16 and 12 wide) served on
the card with ``auto``, which runs their attention on the plain route,
and an explicit ``cuda`` at those widths, which raises.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda_hh.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import execute
from repro_torch.kernels import householder_gemm as hh
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve

pytestmark = pytest.mark.cuda

# normalised max error: float32 sums in another order; bf16 one output
# rounding (2^-8) apart
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# rows on both sides of the decode threshold (DECODE_ROWS = 16), of the
# decode route's 8-row boxes of x and of the 64- and 128-row tiles, and a
# long ragged prefill
ROWS = (1, 2, 8, 9, 16, 17, 63, 64, 65, 129, 4095)
# (d, f, n): smollm-360m's gate_proj at serving's n = 8 (db 120), its
# down_proj at training's n = 32 (db 80), a K ragged against the 64-deep
# K steps (968 = 8 blocks of 121), and the ragged shapes of the other card
# tests (db 12 and 15, f = 70: not a multiple of 8, so SIMT)
LINEARS = ((960, 2560, 8), (2560, 960, 32), (968, 136, 8))
RAGGED = ((5, 96, 96, 8), (67, 120, 70, 8))
# attention in the smoke configs: heads 16 wide (qwen2.5, deepseek-coder)
# and 12 wide (minicpm)
NARROW_HEADS = ("qwen2.5-32b", "deepseek-coder-33b", "minicpm-2b")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the H100 (see README.md)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, t, d, f, n, dtype, seed=0):
    rng = np.random.default_rng(seed + t * d + f + n)
    x = torch.from_numpy(rng.standard_normal((t, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((d, f), np.float32) / d ** .5)
    u = torch.from_numpy(rng.standard_normal((n, d // n), np.float32))
    return x.to(device, dtype), w.to(device, dtype), u.to(device)


def _max_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def _routed(name):
    return {**dict.fromkeys(ops.routes(), 0), f"householder_gemm.{name}": 1}


def _routes_of(rows):
    """The route counts of aligned bf16 calls of these row counts."""
    want = dict.fromkeys(ops.routes(), 0)
    for t in rows:
        want[f"householder_gemm.{hh.route(torch.bfloat16, t, 8, 8, 8, True)}"
             ] += 1
    return want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f,n", LINEARS)
@pytest.mark.parametrize("t", ROWS)
def test_every_route_matches_the_plain_version(cuda_device, t, d, f, n,
                                               dtype):
    x, w, u = _inputs(cuda_device, t, d, f, n, dtype)
    ops.reset_launches()
    y = ops.householder_gemm(x, w, u)
    torch.cuda.synchronize()
    want = hh.route(dtype, t, d, f, n, True)
    assert want == ("simt" if dtype == torch.float32 else
                    "wgmma_decode" if t <= hh.DECODE_ROWS else "wgmma")
    assert ops.routes() == _routed(want)
    assert ops.launches()["householder_gemm"] == 1
    assert y.dtype == dtype and y.shape == (t, f)
    assert _max_err(y, ref.ref_householder_gemm(x, w, u)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f,n", RAGGED)
def test_ragged_shapes_take_their_routes(cuda_device, t, d, f, n, dtype):
    x, w, u = _inputs(cuda_device, t, d, f, n, dtype)
    ops.reset_launches()
    y = ops.householder_gemm(x, w, u)
    torch.cuda.synchronize()
    want = ("simt" if dtype == torch.float32 or f % 8 else "wgmma_decode")
    assert ops.routes() == _routed(want)
    assert _max_err(y, ref.ref_householder_gemm(x, w, u)) < TOL[dtype]


def test_a_misaligned_view_or_many_blocks_take_simt(cuda_device):
    d, f = 960, 256
    x, w, u = _inputs(cuda_device, 8, d, f, 8, torch.bfloat16)
    # x one element into a buffer: contiguous, 2 bytes off 16
    buf = torch.empty(8 * d + 1, dtype=torch.bfloat16, device=cuda_device)
    xv = buf[1:].view(8, d)
    xv.copy_(x)
    ops.reset_launches()
    y = ops.householder_gemm(xv, w, u)
    torch.cuda.synchronize()
    assert ops.routes() == _routed("simt")
    assert _max_err(y, ref.ref_householder_gemm(x, w, u)) < 1e-2
    # n = 64 > WGMMA_MAX_BLOCKS (db 15)
    u64 = torch.randn(64, d // 64, device=cuda_device)
    ops.reset_launches()
    y = ops.householder_gemm(x, w, u64)
    torch.cuda.synchronize()
    assert ops.routes() == _routed("simt")
    assert _max_err(y, ref.ref_householder_gemm(x, w, u64)) < 1e-2


@pytest.mark.parametrize("d,f,n", LINEARS[:2])
def test_a_row_does_not_depend_on_the_rows_beside_it(cuda_device, d, f, n):
    """The two wgmma routes sum every output in one order: rows served in
    a small call (the decode route) equal the same rows of a large one
    (the wgmma route) bit for bit, as Mamba-2's right-padded prefill
    needs."""
    x, w, u = _inputs(cuda_device, 4095, d, f, n, torch.bfloat16)
    ops.reset_launches()
    big = ops.householder_gemm(x, w, u)
    slices = ((0, 1), (7, 9), (30, 46), (100, 164), (4000, 4065),
              (4094, 4095))
    for lo, hi in slices:
        part = ops.householder_gemm(x[lo:hi].contiguous(), w, u)
        assert torch.equal(part, big[lo:hi]), (lo, hi)
    torch.cuda.synchronize()
    assert ops.routes() == _routes_of([4095] + [hi - lo for lo, hi in slices])


def test_qwen_gate_up_takes_several_row_tiles_a_block(cuda_device):
    """qwen2.5-32b's gate/up (5120×27648, n 8) at a prefill's rows: each
    block of the wgmma route takes several row tiles and forms U in the
    first; rows alone (the decode route) equal the large call's rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    d, f, n = 5120, 27648, 8
    w = (torch.randn(d, f, generator=gen, device=cuda_device)
         / d ** .5).bfloat16()
    u = torch.randn(n, d // n, generator=gen, device=cuda_device)
    x = torch.randn(4095, d, generator=gen, device=cuda_device).bfloat16()
    ops.reset_launches()
    y = ops.householder_gemm(x, w, u)
    assert _max_err(y, ref.ref_householder_gemm(x, w, u)) < 1e-2
    slices = ((0, 2), (1000, 1016), (1000, 1064), (4093, 4095))
    for lo, hi in slices:
        assert torch.equal(ops.householder_gemm(x[lo:hi].contiguous(), w, u),
                           y[lo:hi]), (lo, hi)
    torch.cuda.synchronize()
    assert ops.routes() == _routes_of([4095] + [hi - lo for lo, hi in slices])


@pytest.mark.parametrize("t", [2, 4095])
def test_two_calls_are_bitwise_equal(cuda_device, t):
    x, w, u = _inputs(cuda_device, t, 2560, 960, 32, torch.bfloat16)
    a = ops.householder_gemm(x, w, u)
    b = ops.householder_gemm(x, w, u)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_routes_add_up_to_launches_and_reset(cuda_device):
    ops.reset_launches()
    for t, dtype in ((4, torch.bfloat16), (128, torch.bfloat16),
                     (4, torch.float32)):
        ops.householder_gemm(*_inputs(cuda_device, t, 96, 64, 8, dtype))
    torch.cuda.synchronize()
    assert ops.routes() == {"householder_gemm.wgmma": 1,
                            "householder_gemm.wgmma_decode": 1,
                            "householder_gemm.simt": 1}
    assert ops.launches()["householder_gemm"] == 3
    ops.reset_launches()
    assert set(ops.routes().values()) == {0}


@pytest.mark.parametrize("arch", NARROW_HEADS)
def test_auto_serves_narrow_heads_on_the_plain_attention(cuda_device, arch):
    execute.reset_counters()
    ops.reset_launches()
    r = serve.serve(arch=arch, variant="smoke", backend="auto", gen=2,
                    device="cuda")
    torch.cuda.synchronize()
    counts = execute.counters()
    assert counts["flash_attention.torch"] > 0
    assert "flash_attention.cuda" not in counts
    assert ops.launches()["flash_attention"] == 0
    assert counts["householder_gemm.cuda"] > 0
    assert bool(torch.isfinite(r["logits"]).all())


@pytest.mark.parametrize("d", [12, 16])
def test_explicit_cuda_at_a_narrow_head_raises(cuda_device, d):
    q = torch.randn(1, 4, 8, d, device=cuda_device)
    k = torch.randn(1, 2, 8, d, device=cuda_device)
    assert execute.selected_backend("flash_attention", "auto", q, k, k,
                                    causal=True) == "torch"
    with pytest.raises(ops.KernelInputError, match="head widths"):
        execute.dispatch("flash_attention", "cuda", q, k, k, causal=True)
    wide = torch.randn(1, 4, 8, 64, device=cuda_device)
    assert execute.selected_backend("flash_attention", "auto", wide,
                                    wide[:, :2], wide[:, :2]) == "cuda"
