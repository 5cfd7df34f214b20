"""The ETHER+ bank reflections (rows 7 and 25: etherplus_reflect_batched
and its backward) on csrc/rank2_tiles.cuh's tile kernels, on the card.

Both kernels against their plain versions at the shapes of the bank's
serving and training (n 8 and 32, db 10 to 320), at a ragged S, at widths
not a multiple of 8 and with x off 16 bytes (element by element), at a
row wider than one column chunk and a block too wide for a staged tile;
in bf16 and f32.  ids hold a repeat, A − 1, an id ≥ A and a negative one.
dx, ĝ, du and dv bitwise equal over two runs; the tenants that no id
names get exactly zero; and a trace of a bank forward and backward shows
the tile kernels and none of the per-row kernels (reflect_common.cuh's
rank2_rows_kernel, reflect_bwd_kernel and their bank sums) that ran rows
7 and 25 before.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda_rank2.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import batched as kb
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

# normalised max error: float32 sums in another order; bf16 one output
# rounding (2^-8) apart
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# ĝ, du, dv: relative Frobenius (chip_smoke.py's DU_TOL)
DU_TOL = 1e-4
A = 9
# (B, S, d, n): phase 14's train shape at each width (db 30, 10, 80), the
# bank prefill and decode at n 8 (db 320, 120), ragged S, odd db (13, 25),
# d not a multiple of 8 (90, 100), a row of chunks (Llama-2-7B's 11008 at
# n 32, db 344), Llama-2-7B's down_proj input at n 8 (db 1376: the f32
# backward's 32-row tile streams), and single blocks of 16384 (the
# backward streams) and 20480 (the f32 forward streams too)
SHAPES = ((8, 128, 960, 32), (8, 128, 320, 32), (8, 128, 2560, 32),
          (16, 128, 2560, 8), (4, 1, 960, 8), (4, 33, 960, 32),
          (4, 100, 2560, 32), (3, 7, 104, 8), (3, 17, 100, 4),
          (4, 5, 90, 3), (2, 9, 11008, 32), (2, 40, 11008, 8),
          (1, 3, 16384, 1), (1, 2, 20480, 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the H100 (see README.md)")
    return torch.device("cuda")


def _ids(b, device):
    pattern = [5, A - 1, 5, A + 3, -2, 0, 5, 2]
    return torch.tensor((pattern * b)[:b], dtype=torch.int32, device=device)


def _inputs(device, b, s, d, n, dtype, seed=0, offset=0):
    """x, G (at ``offset`` elements into their storage), u, v banks, ids."""
    rng = np.random.default_rng([seed, b, s, d, n])

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    def act():
        buf = torch.empty(b * s * d + offset, dtype=dtype, device=device)
        x = buf[offset:].view(b, s, d)
        x.copy_(randn(b, s, d))
        return x
    x, g = act(), act()
    u, v = (randn(A, n, d // n).to(device) for _ in range(2))
    return x, u, v, _ids(b, device), g


def _max_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def _frob(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def _named(ids):
    return set(ref.bank_index(ids.cpu(), A).tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d,n", SHAPES)
def test_forward_matches_plain(cuda_device, b, s, d, n, dtype):
    x, u, v, ids, _ = _inputs(cuda_device, b, s, d, n, dtype)
    ops.reset_launches()
    got = ops.etherplus_reflect_batched(x, u, v, ids)
    assert ops.launches()["etherplus_reflect_batched"] == 1
    want = ref.ref_etherplus_reflect_batched(x, u, v, ids)
    assert got.dtype == dtype and got.shape == x.shape
    assert _max_err(got, want) <= TOL[dtype]
    assert torch.equal(ops.etherplus_reflect_batched(x, u, v, ids), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d,n", SHAPES)
def test_backward_matches_plain(cuda_device, b, s, d, n, dtype):
    x, u, v, ids, g = _inputs(cuda_device, b, s, d, n, dtype, seed=1)
    err, dx, gu, gv, du, dv = kb.etherplus_reflect_batched_bwd(x, u, v, ids,
                                                               g)
    assert err == 0
    pdx, pgu, pgv = ref.ref_etherplus_reflect_batched_bwd(x, u, v, ids, g)
    assert _max_err(dx, pdx) <= TOL[dtype]
    assert _frob(gu, pgu) <= DU_TOL and _frob(gv, pgv) <= DU_TOL
    assert _frob(du, ref.bank_grad(u, ids, pgu)) <= DU_TOL
    assert _frob(dv, ref.bank_grad(v, ids, pgv)) <= DU_TOL
    named = _named(ids)
    for grad in (du, dv):
        for a in range(A):
            if a in named:
                assert grad[a].abs().max().item() > 0
            else:
                assert torch.equal(grad[a], torch.zeros_like(grad[a]))
    again = kb.etherplus_reflect_batched_bwd(x, u, v, ids, g)
    for p, q in zip((dx, gu, gv, du, dv), again[1:]):
        assert torch.equal(p, q)
    ops.reset_launches()
    wdx, wdu, wdv = ops.etherplus_reflect_batched_bwd(x, u, v, ids, g)
    assert ops.launches()["etherplus_reflect_batched_bwd"] == 1
    assert torch.equal(wdx, dx) and torch.equal(wdu, du)
    assert torch.equal(wdv, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_operands_off_16_bytes_take_element_loads(cuda_device, dtype):
    b, s, d, n = 8, 128, 960, 32
    x, u, v, ids, g = _inputs(cuda_device, b, s, d, n, dtype, seed=2,
                              offset=1)
    assert x.data_ptr() % 16 and kb._geometry(x, u, True, g)[2] == 0
    got = ops.etherplus_reflect_batched(x, u, v, ids)
    assert _max_err(got, ref.ref_etherplus_reflect_batched(
        x, u, v, ids)) <= TOL[dtype]
    dx, du, dv = ops.etherplus_reflect_batched_bwd(x, u, v, ids, g)
    pdx, pdu, pdv = ref.ref_etherplus_reflect_batched_grads(x, u, v, ids, g)
    assert _max_err(dx, pdx) <= TOL[dtype]
    assert _frob(du, pdu) <= DU_TOL and _frob(dv, pdv) <= DU_TOL
    # the aligned copy: the same bits
    xa, ga = x.clone(), g.clone()
    assert torch.equal(ops.etherplus_reflect_batched(xa, u, v, ids), got)
    assert torch.equal(ops.etherplus_reflect_batched_bwd(xa, u, v, ids,
                                                         ga)[0], dx)


def test_a_bank_run_traces_only_the_tile_kernels(cuda_device):
    """Forward and backward through EtherPlusReflectBatched on both sides
    of a product, bf16 and f32, as ETHER+'s bank_dense runs them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import execute
    names = set()
    for dtype in (torch.bfloat16, torch.float32):
        x, u, v, ids, _ = _inputs(cuda_device, 8, 128, 960, 32, dtype,
                                  seed=3)
        w = torch.randn(960, 320, device=cuda_device).to(dtype)
        u2, v2 = (torch.randn(A, 32, 10, device=cuda_device)
                  for _ in range(2))
        for t in (x, u, v, u2, v2):
            t.requires_grad_(True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            xr = execute.EtherPlusReflectBatched.apply(x, u, v, ids, "cuda")
            y = execute.EtherPlusReflectBatched.apply(xr @ w, u2, v2, ids,
                                                      "cuda")
            y.float().square().sum().backward()
            torch.cuda.synchronize()
        names |= {e.key for e in prof.key_averages()}
    tile = {"rank2_tile_kernel", "rank2_tile_bwd_kernel", "bank_ghat_kernel"}
    assert all(any(k in nm for nm in names) for k in tile), names
    old = ("rank2_rows_kernel", "reflect_bwd_kernel", "seq_ghat_kernel",
           "bank_chain_kernel")
    assert not [nm for nm in names if any(k in nm for k in old)], names


def test_tenants_no_id_names_stay_zero_with_every_id_out_of_range(
        cuda_device):
    x, u, v, _, g = _inputs(cuda_device, 4, 33, 960, 32, torch.bfloat16)
    ids = torch.tensor([A + 5, -1, A, 2 * A], dtype=torch.int64,
                       device=cuda_device)
    dx, du, dv = ops.etherplus_reflect_batched_bwd(x, u, v, ids, g)
    pdx, pdu, pdv = ref.ref_etherplus_reflect_batched_grads(x, u, v, ids, g)
    assert _max_err(dx, pdx) <= TOL[torch.bfloat16]
    assert _frob(du, pdu) <= DU_TOL and _frob(dv, pdv) <= DU_TOL
    assert _named(ids) == {A - 1}
    assert torch.equal(du[:A - 1], torch.zeros_like(du[:A - 1]))
    assert torch.equal(dv[:A - 1], torch.zeros_like(dv[:A - 1]))
