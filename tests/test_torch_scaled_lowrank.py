"""The wgmma routes of delora_gemm_batched (DeLoRA's bank: x itself as one
plane and a low-rank epilogue) and hyperadapt_gemm (HyperAdapt with one
tenant), their route rules and the trace patterns, on the CPU.

Both run ``csrc/scaled_wgmma.cuh``'s core.  DeLoRA's: x·W summed on the
tensor cores over each 64-deep K tile, the partials added in order; a
prologue's hs[m, j] = fl32(Σ_k x[m, k]·a_t[k, j] in f64)·s_t[j], t each
row's tenant (ids mapped into [0, A) as the JAX gather maps them); the
epilogue's Σ_j hs[m, j]·b_t[j, col], an f32 FMA chain in j order, added
to the sum before one rounding.  Its backward's dx = G·Wᵀ + ((G·b_tᵀ)·
s_t)·a_tᵀ runs the same arithmetic with W read K-major and the banks
read where they lie.  HyperAdapt's one tenant is the bank's route with a
bank of one: x⊙r in f32 as a bf16 hi and lo plane, hi·W + lo·W, ⊙c, one
rounding.  ``_emulate_delora`` and ``_emulate_hyperadapt`` repeat that
arithmetic here, in this file alone, and the tests hold it against the
JAX package (``repro.kernels.ref`` and the Pallas kernels in interpret
mode) on the same seeded numpy inputs, at the main paths' widths (f
narrow where time demands): bf16 by relative Frobenius (1e-2: one more
rounding on the kernel's side), the same algebra without the roundings
in float32 by normalised max error (1e-5: the f32 sums in another
order).  The CUDA kernels run on the card (tests/test_torch_cuda_scaled.py).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.delora_gemm import delora_gemm_batched_pallas
from repro.kernels.hyperadapt_gemm import hyperadapt_gemm_pallas
from repro_torch.kernels import batched
from repro_torch.kernels import hyperadapt_gemm as kh
from repro_torch.kernels import ops, ref

BF16_TOL, F32_TOL = 1e-2, 1e-5
# the K the tensor cores sum into one partial: a K tile
PART_K = 64
# (B, S, d, f, A): the bank at the paths' B and S (decode, prefill, a
# ragged S, train), f narrow
DL_WIDTHS = [(4, 1, 960, 64, 64), (4, 33, 960, 48, 64),
             (2, 128, 2560, 40, 8), (16, 5, 960, 24, 64)]
RANKS = (8, 64)
# (T, d, f): one tenant's rows at decode, prefill and train, f narrow
HA_WIDTHS = [(4, 960, 320), (128, 960, 40), (200, 2560, 24)]


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


def _emulate_delora(x, w, a_bank, b_bank, s_bank, ids, dx=False,
                    round_to_bf16=True):
    """The wgmma route's arithmetic on x (B, S, K): y = x·W (64-deep
    partials) + lr, lr[m, col] = Σ_j hs[m, j]·q_t[j, col] summed in j
    order, hs = fl32(Σ_k x·p_t in f64)·s_t, rounded once.  The forward
    reads W (K, N), p = a (A, K, r), q = b (A, r, N); ``dx`` reads W as
    the transpose of the (N, K) weight, p = b (A, r, K) along its rows and
    q = a (A, N, r) down its columns."""
    b, s, k = x.shape
    m = b * s
    t = _tenant(ids, m, s, a_bank.shape[0])
    xm = x.reshape(m, k)
    wk = torch.as_tensor(w, dtype=torch.float32)
    wk = wk.T if dx else wk
    p = np.swapaxes(b_bank, 1, 2) if dx else a_bank        # (A, K, r)
    q = np.swapaxes(a_bank, 1, 2) if dx else b_bank        # (A, r, N)
    h64 = np.einsum("mk,mkr->mr", xm.astype(np.float64),
                    p[t].astype(np.float64))
    hs = h64.astype(np.float32) * s_bank[t].astype(np.float32)
    lr = np.zeros((m, q.shape[2]), np.float32)
    for j in range(q.shape[1]):   # an FMA chain: one rounding a step
        lr = (lr.astype(np.float64) + hs[:, j:j + 1].astype(np.float64)
              * q[t, j].astype(np.float64)).astype(np.float32)
    y = _product(torch.from_numpy(xm), wk) + torch.from_numpy(lr)
    y = y.bfloat16().float() if round_to_bf16 else y
    return y.numpy().reshape(b, s, -1)


def _emulate_hyperadapt(x, w, r, c, w_t=False, round_to_bf16=True):
    """One tenant's route on x (T, K): v = x⊙r in f32 as a bf16 hi plane
    and a bf16 lo plane (v − hi rounded), hi·W + lo·W in f32 (64-deep
    partials), then ⊙c (left out without c), rounded once."""
    xr = torch.from_numpy(x * r)
    if round_to_bf16:
        hi = xr.bfloat16().float()
        xr = hi + (xr - hi).bfloat16().float()
    wk = torch.as_tensor(w, dtype=torch.float32)
    y = _product(xr, wk.T if w_t else wk)
    if c is not None:
        y = y * torch.from_numpy(c)
    return (y.bfloat16().float() if round_to_bf16 else y).numpy()


def _dl_inputs(b, s, d, f, a, r):
    rng = _rng(5, b, s, d, f, a, r)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    ab = rng.standard_normal((a, d, r)).astype(np.float32)
    bb = rng.standard_normal((a, r, f)).astype(np.float32)
    # the method's scale (λ/r)/(‖a_j‖‖b_j‖), λ = 2, in bf16
    sb = _bf16((2.0 / r) / (np.linalg.norm(ab, axis=1)
                            * np.linalg.norm(bb, axis=2)))
    ids = rng.integers(-2, a + 2, b).astype(np.int32)   # −2 .. A + 1
    return x, w, ab, bb, sb, ids


@pytest.mark.parametrize("dx", [False, True])
@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("b,s,d,f,a", DL_WIDTHS)
def test_emulated_delora_route_matches_jax(b, s, d, f, a, r, dx):
    """Forward (W N-major) and the backward's dx (W K-major, the banks
    where they lie), ids outside [0, A) among them."""
    x, w, ab, bb, sb, ids = _dl_inputs(b, s, d, f, a, r)
    if dx:   # the cotangent (B, S, f); dx is (B, S, d)
        x = _rng(6, b, s, f).standard_normal((b, s, f)).astype(np.float32)
    xb, wb = _bf16(x), _bf16(w)
    got = _emulate_delora(xb, wb, ab, bb, sb, ids, dx)
    if dx:   # the JAX composition's dx: the forward on Wᵀ, bᵀ and aᵀ
        want = jref.ref_delora_gemm_batched(
            jnp.asarray(xb), jnp.asarray(wb).T,
            jnp.swapaxes(jnp.asarray(bb), 1, 2),
            jnp.swapaxes(jnp.asarray(ab), 1, 2), jnp.asarray(sb),
            jnp.asarray(ids))
    else:
        want = jref.ref_delora_gemm_batched(
            *(jnp.asarray(v) for v in (xb, wb, ab, bb, sb, ids)))
    assert _frob(got, want) < BF16_TOL
    f32 = _emulate_delora(x, w, ab, bb, sb, ids, dx, round_to_bf16=False)
    tx = torch.from_numpy
    plain = (ref.ref_delora_gemm_batched(
        tx(x), tx(np.ascontiguousarray(w.T)), tx(bb).transpose(1, 2),
        tx(ab).transpose(1, 2), tx(sb), tx(ids)) if dx
        else ref.ref_delora_gemm_batched(tx(x), tx(w), tx(ab), tx(bb),
                                         tx(sb), tx(ids)))
    assert _max_err(f32, plain.numpy()) < F32_TOL


def test_emulated_delora_route_matches_interpret_pallas():
    x, w, ab, bb, sb, ids = _dl_inputs(2, 16, 256, 128, 3, 8)
    ids = np.clip(ids, 0, 2)
    want = delora_gemm_batched_pallas(
        *(jnp.asarray(v) for v in (x, w, ab, bb, sb, ids)), interpret=True)
    assert _max_err(_emulate_delora(x, w, ab, bb, sb, ids,
                                    round_to_bf16=False), want) < F32_TOL


def test_delora_rows_are_their_tenants_alone():
    """B = 40 sequences of S = 3 rows: a 128-row tile holds rows of up to
    40 tenants.  Each row is its own tenant's, bitwise as a call of that
    sequence alone (whose tiles name one tenant), whichever way the
    epilogue reads b_t."""
    x, w, ab, bb, sb, _ = _dl_inputs(40, 3, 960, 24, 6, 8)
    ids = (np.arange(40) % 9 - 1).astype(np.int32)
    xb, wb = _bf16(x), _bf16(w)
    got = _emulate_delora(xb, wb, ab, bb, sb, ids)
    for i in (0, 7, 39):
        alone = _emulate_delora(xb[i:i + 1], wb, ab, bb, sb, ids[i:i + 1])
        assert np.array_equal(got[i], alone[0])


def test_hs_is_the_f64_sum_rounded_once():
    """The prologue's h: every product of a bf16 and an f32 is exact in
    f64, so h is the f32 nearest the exact sum (here at 960 terms, where
    an f32 chain would miss it)."""
    rng = _rng(7)
    x = _bf16(rng.standard_normal((64, 960)).astype(np.float32))
    a = rng.standard_normal((960, 8)).astype(np.float32)
    exact = np.einsum("mk,kr->mr", x.astype(np.float64),
                      a.astype(np.float64))
    h = exact.astype(np.float32)
    chain = np.zeros((64, 8), np.float32)
    for k in range(960):
        chain = (chain + x[:, k:k + 1] * a[k]).astype(np.float32)
    assert np.abs(h.astype(np.float64) - exact).max() <= np.abs(
        chain.astype(np.float64) - exact).max()
    assert (h != chain).any()


@pytest.mark.parametrize("w_t", [False, True])
@pytest.mark.parametrize("t,d,f", HA_WIDTHS)
def test_emulated_hyperadapt_single_route_matches_jax(t, d, f, w_t):
    """Forward (r, c; W N-major) and, W read K-major, the backward's z =
    (g⊙c)·Wᵀ without a column scale; y0 = (x⊙r)·W is the forward without
    c."""
    rng = _rng(8, t, d, f)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    r = (1 + 0.3 * rng.standard_normal(d)).astype(np.float32)
    c = (1 + 0.3 * rng.standard_normal(f)).astype(np.float32)
    k = f if w_t else d
    x = rng.standard_normal((t, k)).astype(np.float32)
    xb, wb = _bf16(x), _bf16(w)
    row, col = (c, None) if w_t else (r, c)
    got = _emulate_hyperadapt(xb, wb, row, col, w_t)
    wj = jnp.asarray(wb).T if w_t else jnp.asarray(wb)
    want = (jnp.asarray(xb) * jnp.asarray(row)) @ wj
    if col is not None:
        want = jref.ref_hyperadapt_gemm(jnp.asarray(xb), wj, jnp.asarray(r),
                                        jnp.asarray(c))
    assert _frob(got, want) < BF16_TOL
    f32 = _emulate_hyperadapt(x, w, row, col, w_t, round_to_bf16=False)
    plain = ref.ref_hyperadapt_gemm(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(
            w.T if w_t else w)), torch.from_numpy(row),
        None if col is None else torch.from_numpy(col))
    assert _max_err(f32, plain.numpy()) < F32_TOL


def test_emulated_hyperadapt_single_route_matches_interpret_pallas():
    rng = _rng(9)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) / 16).astype(np.float32)
    r = (1 + 0.3 * rng.standard_normal(256)).astype(np.float32)
    c = (1 + 0.3 * rng.standard_normal(128)).astype(np.float32)
    want = hyperadapt_gemm_pallas(*(jnp.asarray(v) for v in (x, w, r, c)),
                                  interpret=True)
    assert _max_err(_emulate_hyperadapt(x, w, r, c, round_to_bf16=False),
                    want) < F32_TOL


def test_one_tenant_is_a_bank_of_one():
    """The single tenant's arithmetic is the bank's at every id naming
    tenant 0: the same bits."""
    rng = _rng(10)
    x = _bf16(rng.standard_normal((2, 64, 960)).astype(np.float32))
    w = _bf16((rng.standard_normal((960, 40)) / 31).astype(np.float32))
    r = (1 + 0.3 * rng.standard_normal(960)).astype(np.float32)
    c = (1 + 0.3 * rng.standard_normal(40)).astype(np.float32)
    one = _emulate_hyperadapt(x.reshape(128, 960), w, r, c)
    xr = torch.from_numpy(x.reshape(128, 960) * r[None].repeat(128, 0))
    hi = xr.bfloat16().float()
    bank = ((_product(hi + (xr - hi).bfloat16().float(), torch.from_numpy(w))
             * torch.from_numpy(c)).bfloat16().float().numpy())
    assert np.array_equal(one, bank)


@pytest.mark.parametrize("dtype,d,f,r,aligned,want", [
    (torch.bfloat16, 960, 2560, 8, True, "wgmma"),
    (torch.bfloat16, 2560, 960, 64, True, "wgmma"),
    (torch.bfloat16, 960, 960, 65, True, "simt"),
    (torch.bfloat16, 960, 960, 512, True, "simt"),
    (torch.bfloat16, 964, 960, 8, True, "simt"),
    (torch.bfloat16, 960, 964, 8, True, "simt"),
    (torch.bfloat16, 960, 960, 8, False, "simt"),
    (torch.float32, 960, 960, 8, True, "simt"),
])
def test_delora_bank_route_rule(dtype, d, f, r, aligned, want):
    """One rule for the wgmma cores, ``householder_gemm.wgmma_takes`` with
    no reflection blocks, and r within the low-rank epilogue's."""
    assert batched.delora_route(dtype, d, f, r, aligned) == want
    assert (want == "wgmma") == (r <= batched.LOWRANK_MAX_RANK and
                                 kh.route(dtype, d, f, aligned) == "wgmma")


@pytest.mark.parametrize("dtype,d,f,aligned,want", [
    (torch.bfloat16, 960, 2560, True, "wgmma"),
    (torch.bfloat16, 2560, 960, True, "wgmma"),
    (torch.bfloat16, 964, 960, True, "simt"),
    (torch.bfloat16, 960, 964, True, "simt"),
    (torch.bfloat16, 960, 960, False, "simt"),
    (torch.float32, 960, 960, True, "simt"),
])
def test_hyperadapt_single_route_rule(dtype, d, f, aligned, want):
    """The single tenant's rule is the bank's."""
    assert kh.route(dtype, d, f, aligned) == want
    assert batched.hyperadapt_route(dtype, d, f, aligned) == want


def test_hyperadapt_single_route_reads_every_operand_it_loads():
    x = torch.zeros(3, 960, dtype=torch.bfloat16)
    w = torch.zeros(960, 64, dtype=torch.bfloat16)
    r, c = torch.zeros(960), torch.zeros(64)
    assert kh.pick(x, w, r, c) == "wgmma"
    assert kh.pick(x, w, r, None) == "wgmma"
    assert kh.pick(x, w, torch.zeros(961)[1:], c) == "simt"
    assert kh.pick(x, w, r, torch.zeros(65)[1:]) == "simt"
    assert kh.pick(torch.zeros(3 * 960 + 4, dtype=torch.bfloat16)[4:].view(
        3, 960), w, r, c) == "simt"
    assert kh.pick(torch.zeros(3, 64, dtype=torch.bfloat16), w, c, None,
                   w_t=True) == "wgmma"


def test_cpu_calls_count_no_launch_and_no_route():
    x, w, ab, bb, sb, ids = (torch.from_numpy(v) for v in
                             _dl_inputs(2, 3, 960, 40, 3, 8))
    xb, wb, sbb = x.bfloat16(), w.bfloat16(), sb.bfloat16()
    g = torch.ones(2, 3, 40, dtype=torch.bfloat16)
    ops.reset_launches()
    ops.delora_gemm_batched(xb, wb, ab, bb, sbb, ids)
    ops.delora_gemm_batched_bwd(xb, wb, ab, bb, sbb, ids, g, need_dw=False)
    r, c = torch.ones(960), torch.ones(40)
    ops.hyperadapt_gemm(xb[0], wb, r, c)
    ops.hyperadapt_gemm_bwd(xb[0], wb, r, c, g[0], need_dw=False)
    for op, names in (("delora_gemm_batched", batched.DL_ROUTES),
                      ("hyperadapt_gemm", kh.ROUTES)):
        assert set(ops.routes(op)) == {f"{op}.{n}" for n in names}
        assert set(ops.routes(op).values()) == {0}
        assert ops.launches()[op] == 0


@pytest.fixture(scope="module")
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SW = "sw::(anonymous namespace)::"


@pytest.mark.parametrize("name,op", [
    (f"void {_SW}gemm_kernel<128, 0, 5>(CUtensorMap, CUtensorMap, "
     f"{_SW}Args)", "hyperadapt_gemm"),
    (f"void {_SW}gemm_kernel<64, 0, 5>(CUtensorMap, CUtensorMap, "
     f"{_SW}Args)", "hyperadapt_gemm"),
    (f"void {_SW}gemm_kernel<128, 1, 4>(CUtensorMap, CUtensorMap, "
     f"{_SW}Args)", "hyperadapt_gemm"),
    (f"{_SW}scale_rows_kernel(__nv_bfloat16 const*, float const*, "
     "__nv_bfloat16*, int, int)", "hyperadapt_gemm"),
    (f"{_SW}scale_rows_kernel(__nv_bfloat16 const*, float const*, "
     "__nv_bfloat16*, reflect::Tenants, int, int)",
     "hyperadapt_gemm_batched"),
    (f"void {_SW}gemm_kernel<128, 0, 1>(CUtensorMap, CUtensorMap, "
     f"{_SW}Args)", "hyperadapt_gemm_batched"),
    (f"void {_SW}gemm_kernel<128, 0, 2>(CUtensorMap, CUtensorMap, "
     f"{_SW}Args)", "delora_gemm_batched"),
    (f"void {_SW}gemm_kernel<64, 1, 2>(CUtensorMap, CUtensorMap, "
     f"{_SW}Args)", "delora_gemm_batched"),
    (f"{_SW}lowrank_h_kernel(__nv_bfloat16 const*, float const*, long "
     "long, int, int, __nv_bfloat16 const*, float*, reflect::Tenants, int, "
     "int, int)", "delora_gemm_batched"),
    ("void (anonymous namespace)::h_kernel<__nv_bfloat16>(__nv_bfloat16 "
     "const*, float const*, long long, int, int, float*, int, int, int, "
     "reflect::Tenants)", None),
])
def test_the_traces_name_each_scaled_kernel_once(chip_smoke, name, op):
    """chip_smoke.py's trace patterns: the scaled core's kernels of each
    op (by their demangled names) go to that op alone; the SIMT route's
    h pass to none."""
    hits = [o for o, pats in chip_smoke.FWD_KERNELS.items()
            if any(all(k in name for k in keys) for keys in pats)]
    assert hits == ([] if op is None else [op])


@pytest.mark.parametrize("b,s,want", [
    ((4, 1, (0, 1))), ((4, 32, (0, 1))), ((16, 128, (16, 16))),
    ((4, 33, (1, 2))), ((64, 1, (0, 1)))])
def test_phase_2_counts_the_tiles_that_stage(chip_smoke, b, s, want):
    """The low-rank epilogue stages b_t where a tile's rows name one
    tenant: at the bank's train size every 128-row tile, at decode and
    the 4 × 32 prefill none, at the ragged 4 × 33 the last tile alone."""
    ids = torch.tensor(chip_smoke.BANK_IDS * (b // 4) if b <= 16
                       else list(range(b)), dtype=torch.int32)
    assert chip_smoke.staged_tiles(ids, s, chip_smoke.BANK_TENANTS) == want
