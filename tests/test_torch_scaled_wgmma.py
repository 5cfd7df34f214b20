"""The wgmma route of hyperadapt_gemm_batched (HyperAdapt's row and
column scales on either side of the tensor-core product, each row its
own tenant's), its route rule and the trace patterns, on the CPU.

The route runs ``csrc/scaled_wgmma.cuh``'s core: x⊙r_t in f32 as a bf16
hi and lo plane, t each row's tenant (ids mapped into [0, A) as the JAX
gather maps them); the tensor cores' f32 sums of both planes with W over
each 64-deep K tile, added in order; then ⊙c_t and one rounding.  W is
read as stored (d, f) or, for the backward's z = (g⊙c_t)·Wᵀ, as the
transpose of the (f, d) weight.  ``_emulate_hyperadapt`` repeats that
arithmetic here, in this file alone,
and the tests hold it against the JAX package (``repro.kernels.ref`` and
the Pallas kernels in interpret mode) on the same seeded numpy inputs, at
the main paths' widths (smollm-360m's d, f narrow where time demands):
bf16 by relative Frobenius (1e-2: one more rounding on the kernel's
side), the same algebra without the roundings in float32 by normalised
max error (1e-5: the f32 sums in another order).  The CUDA kernels run
on the card (tests/test_torch_cuda_scaled.py)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.hyperadapt_gemm import hyperadapt_gemm_batched_pallas
from repro_torch.kernels import batched
from repro_torch.kernels import householder_gemm as hh
from repro_torch.kernels import ops, ref

BF16_TOL, F32_TOL = 1e-2, 1e-5
# the K the tensor cores sum into one partial: a K tile
PART_K = 64
# (B, S, d, f, A): the bank at the paths' B and S, f narrow
HA_WIDTHS = [(4, 1, 960, 960, 64), (4, 32, 960, 64, 64),
             (8, 5, 2560, 48, 8), (64, 1, 960, 40, 64)]


def _rng(*key):
    return np.random.default_rng(list(key))


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _product(x, w):
    """x·W in f32 as the core sums it: each PART_K-deep K tile summed
    apart (the tensor cores' partial), the partials added in order."""
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], PART_K):
        acc = acc + x[:, k0:k0 + PART_K] @ w[k0:k0 + PART_K]
    return acc


def _tenant(ids, rows, seq, count):
    """Each row's tenant as row_tenant reads it on the device: sequence
    m / seq's id, a negative one counted from the end, then clamped."""
    t = np.asarray(ids, np.int64)[np.arange(rows) // seq]
    t = np.where(t < 0, t + count, t)
    return np.clip(t, 0, count - 1)


def _emulate_hyperadapt(x, w, r_bank, c_bank, ids, w_t=False,
                        round_to_bf16=True):
    """The wgmma route's arithmetic on x (B, S, d): v = x⊙r_t in f32 as a
    bf16 hi plane and a bf16 lo plane (v − hi rounded), acc = hi·W + lo·W
    in f32, then acc⊙c_t (left out without c_bank), rounded once; t each
    row's own tenant."""
    b, s, d = x.shape
    t = _tenant(ids, b * s, s, r_bank.shape[0])
    xr = torch.from_numpy(x.reshape(b * s, d) * r_bank[t])
    if round_to_bf16:
        hi = xr.bfloat16().float()
        xr = hi + (xr - hi).bfloat16().float()
    wk = torch.as_tensor(w, dtype=torch.float32)
    y = _product(xr, wk.T if w_t else wk)
    if c_bank is not None:
        y = y * torch.from_numpy(c_bank[t])
    y = y.bfloat16().float() if round_to_bf16 else y
    return y.numpy().reshape(b, s, -1)


def _ha_inputs(b, s, d, f, a):
    rng = _rng(4, b, s, d, f, a)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    rb = (1 + 0.3 * rng.standard_normal((a, d))).astype(np.float32)
    cb = (1 + 0.3 * rng.standard_normal((a, f))).astype(np.float32)
    ids = rng.integers(0, a, b).astype(np.int32)
    return x, w, rb, cb, ids


@pytest.mark.parametrize("w_t", [False, True])
@pytest.mark.parametrize("b,s,d,f,a", HA_WIDTHS)
def test_emulated_hyperadapt_route_matches_jax(b, s, d, f, a, w_t):
    """Forward (row scale r, column scale c) and, W read transposed, the
    backward's z = (g⊙c_t)·Wᵀ without a column scale."""
    x, w, rb, cb, ids = _ha_inputs(b, s, d, f, a)
    if w_t:
        x = _rng(6, b, s, f).standard_normal((b, s, f)).astype(np.float32)
        rb, cb = cb, None
    xb, wb = _bf16(x), _bf16(w)
    wj = wb.T if w_t else wb
    got = _emulate_hyperadapt(xb, wb, rb, cb, ids, w_t)
    if cb is None:   # the JAX bank backward's z: (g⊙c_t) rounded, then ·Wᵀ
        want = jnp.einsum("bsk,kn->bsn", jnp.asarray(xb) * jnp.asarray(
            rb)[jnp.asarray(ids)][:, None], jnp.asarray(wj))
    else:
        want = jref.ref_hyperadapt_gemm_batched(
            jnp.asarray(xb), jnp.asarray(wj), jnp.asarray(rb),
            jnp.asarray(cb), jnp.asarray(ids))
    assert _frob(got, want) < BF16_TOL
    f32 = _emulate_hyperadapt(x, w, rb, cb, ids, w_t, round_to_bf16=False)
    plain = ref.ref_hyperadapt_gemm_batched(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(
            w.T if w_t else w)), torch.from_numpy(rb),
        None if cb is None else torch.from_numpy(cb), torch.from_numpy(ids))
    assert _max_err(f32, plain.numpy()) < F32_TOL


def test_emulated_hyperadapt_route_matches_interpret_pallas():
    x, w, rb, cb, ids = _ha_inputs(2, 16, 256, 128, 3)
    want = hyperadapt_gemm_batched_pallas(
        *(jnp.asarray(v) for v in (x, w, rb, cb, ids)), interpret=True)
    assert _max_err(_emulate_hyperadapt(x, w, rb, cb, ids,
                                        round_to_bf16=False),
                    want) < F32_TOL


def test_a_row_tile_spans_tenants_and_maps_ids_as_the_forward():
    """B = 40 sequences of S = 3 rows: a 128-row tile holds rows of up to
    40 tenants, ids past A and below 0 among them.  Each row is its own
    tenant's, bitwise as a call of that sequence alone, and the JAX
    reference (whose gather clamps the same ids) agrees."""
    b, s, d, f, a = 40, 3, 960, 24, 6
    x, w, rb, cb, _ = _ha_inputs(b, s, d, f, a)
    ids = (np.arange(b) % (a + 3) - 1).astype(np.int32)   # −1 .. A + 1
    assert ids.min() < 0 and ids.max() >= a
    xb, wb = _bf16(x), _bf16(w)
    got = _emulate_hyperadapt(xb, wb, rb, cb, ids)
    for i in range(b):
        alone = _emulate_hyperadapt(xb[i:i + 1], wb, rb, cb, ids[i:i + 1])
        assert np.array_equal(got[i], alone[0])
    want = jref.ref_hyperadapt_gemm_batched(
        *(jnp.asarray(v) for v in (xb, wb, rb, cb, ids)))
    assert _frob(got, want) < BF16_TOL
    mapped = ref.bank_index(torch.from_numpy(ids), a).numpy()
    assert np.array_equal(mapped, _tenant(ids, b, 1, a))


@pytest.mark.parametrize("dtype,d,f,aligned,want", [
    (torch.bfloat16, 960, 2560, True, "wgmma"),
    (torch.bfloat16, 2560, 960, True, "wgmma"),
    (torch.bfloat16, 964, 960, True, "simt"),
    (torch.bfloat16, 960, 964, True, "simt"),
    (torch.bfloat16, 960, 960, False, "simt"),
    (torch.float32, 960, 960, True, "simt"),
])
def test_hyperadapt_bank_route_rule(dtype, d, f, aligned, want):
    """One rule for the wgmma cores: the scaled core takes what
    ``householder_gemm.wgmma_takes`` takes with no reflection blocks."""
    assert batched.hyperadapt_route(dtype, d, f, aligned) == want
    assert hh.wgmma_takes(dtype, d, f, 0, aligned) == (want == "wgmma")


def test_hyperadapt_route_reads_every_operand_it_loads():
    """A misaligned view of x, w or either bank takes ``simt``; a missing
    column scale (the backward's z and y0) is no operand."""
    x = torch.zeros(2, 3, 968, dtype=torch.bfloat16)[:, :, 8:]
    w = torch.zeros(960, 64, dtype=torch.bfloat16)
    rb, cb = torch.zeros(4, 960), torch.zeros(5, 64)[1:]
    assert batched.pick_hyperadapt(x.contiguous(), w, rb, cb) == "wgmma"
    assert batched.pick_hyperadapt(x.contiguous(), w, rb, None) == "wgmma"
    assert batched.pick_hyperadapt(x.contiguous(), w, rb, torch.zeros(
        5 * 64 + 1)[1:].view(5, 64)) == "simt"
    assert batched.pick_hyperadapt(
        torch.zeros(6000, dtype=torch.bfloat16)[4:4 + 2 * 3 * 960].view(
            2, 3, 960), w, rb, cb) == "simt"


def test_cpu_calls_count_no_launch_and_no_route():
    xb, wb, rb, cb, ids = (torch.from_numpy(v) for v in
                           _ha_inputs(2, 3, 960, 40, 3))
    ops.reset_launches()
    ops.hyperadapt_gemm_batched(xb.bfloat16(), wb.bfloat16(), rb, cb, ids)
    ops.hyperadapt_gemm_batched_bwd(
        xb.bfloat16(), wb.bfloat16(), rb, cb, ids,
        torch.ones(2, 3, 40, dtype=torch.bfloat16), need_dw=False)
    op = "hyperadapt_gemm_batched"
    assert set(ops.routes(op)) == {f"{op}.{r}" for r in batched.HA_ROUTES}
    assert set(ops.routes(op).values()) == {0}
    assert ops.launches()[op] == 0


@pytest.fixture(scope="module")
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,op", [
    ("void sw::(anonymous namespace)::gemm_kernel<64, 0, 1>(CUtensorMap, "
     "CUtensorMap, sw::(anonymous namespace)::Args)",
     "hyperadapt_gemm_batched"),
    ("void sw::(anonymous namespace)::gemm_kernel<128, 0, 1>(CUtensorMap, "
     "CUtensorMap, sw::(anonymous namespace)::Args)",
     "hyperadapt_gemm_batched"),
    ("void sw::(anonymous namespace)::gemm_kernel<128, 1, 0>(CUtensorMap, "
     "CUtensorMap, sw::(anonymous namespace)::Args)",
     "hyperadapt_gemm_batched"),
    ("sw::(anonymous namespace)::scale_rows_kernel(__nv_bfloat16 const*, "
     "float const*, __nv_bfloat16*, reflect::Tenants, int, int)",
     "hyperadapt_gemm_batched"),
    ("void hhw::(anonymous namespace)::wgmma_kernel<128, 1, true, 0>("
     "CUtensorMap, CUtensorMap, hhw::(anonymous namespace)::Args)",
     "householder_gemm_batched"),
    ("void reflect::(anonymous namespace)::gemm_kernel<__nv_bfloat16, "
     "__nv_bfloat16, __nv_bfloat16, true, true, (reflect::Reflect)0, "
     "(reflect::Fuse)2, false>(...)", None),
])
def test_the_traces_name_each_forward_kernel_once(chip_smoke, name, op):
    """chip_smoke.py's trace patterns: each wgmma core's kernels (by their
    demangled names) go to their own op, and the SIMT GEMM to none."""
    hits = [o for o, pats in chip_smoke.FWD_KERNELS.items()
            if any(all(k in name for k in keys) for keys in pats)]
    assert hits == ([] if op is None else [op])
