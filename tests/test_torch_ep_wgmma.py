"""The wgmma routes of etherplus_gemm (ETHER+'s rank 2, with H̃⁺ in the
epilogue) and householder_gemm_batched (one tenant a row tile), their
route rules and their tile layouts, on the CPU.

Both routes run ``csrc/hh_wgmma.cuh``'s core.  ETHER+'s computes
y0 = x·W − P·U + Q·V with the tensor cores' f32 sum of the stored bf16 x
and W, P and Q the prologue's block projections, U = ÛᵀW and V = V̂ᵀW
summed on the CUDA cores in two 32-row halves of each 64-row K step, the
halves added in order; two-sided, H̃⁺ runs on the f32 y0 of column tiles
holding whole output blocks (``fused``) or on all of y0 (``scratch``),
and y is rounded once.  The bank's takes row tiles of 128 rows of one
sequence each, U formed from the tile's tenant's u in quarters, as row
1's.  ``_emulate_ep`` and ``_emulate_bank`` repeat that arithmetic here,
in this file alone, and the tests hold it against the JAX package
(``repro.kernels.ref`` and the Pallas kernels in interpret mode) on the
same seeded numpy inputs, at the main paths' widths: ETHER+ at db 30 and
80 with db_out 30, 10 and 80 (n 32) and db 120 with db_out 120, 40 and
320 (n 8); the bank at n 8 and 32 with S 128, 32 and 33.  The CUDA
kernels run on the card (tests/test_torch_cuda_ep.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.etherplus_gemm import etherplus_gemm_pallas
from repro.kernels.householder_gemm_batched import \
    householder_gemm_batched_pallas
from repro_torch.core.transforms import resolve_blocks
from repro_torch.kernels import batched
from repro_torch.kernels import etherplus_gemm as ep
from repro_torch.kernels import householder_gemm as hh
from repro_torch.kernels import ops, ref
from repro_torch.kernels import reflect_gemm_dx as dx

# bf16: one rounding of the f32 result on the kernel's side, relative
# Frobenius; float32: the same f32 math in another order of the sums,
# normalised max error
BF16_TOL, F32_TOL = 1e-2, 1e-5
K_STEP = 64
# (t, d, f, n): db = d / n, db_out = f / resolve_blocks(n, f)
EP_WIDTHS = [(5, 960, 960, 32), (7, 960, 320, 32), (6, 960, 2560, 32),
             (4, 2560, 960, 32), (5, 960, 960, 8), (3, 960, 320, 8),
             (3, 960, 2560, 8)]
# (B, S, d, f, n, A): the bank at the main paths' S, f narrow
BANK_WIDTHS = [(2, 128, 960, 64, 8, 3), (3, 32, 960, 40, 32, 4),
               (2, 33, 960, 48, 8, 3), (2, 200, 960, 24, 32, 2)]


def _rng(*key):
    return np.random.default_rng(list(key))


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _ep_inputs(t, d, f, n):
    rng = _rng(1, t, d, f, n)
    n_out = resolve_blocks(n, f)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    u1, v1 = (rng.standard_normal((n, d // n)).astype(np.float32)
              for _ in range(2))
    u2, v2 = (rng.standard_normal((n_out, f // n_out)).astype(np.float32)
              for _ in range(2))
    return x, w, u1, v1, u2, v2


def _parts(u, w, parts):
    """Σ_k u[k]·W[k, :] per block, over ``parts`` equal parts of each
    64-row K step, each part's sum kept apart: (parts, n, f)."""
    n, db = u.shape
    d = n * db
    rows = torch.arange(d)
    out = torch.zeros(parts, n, w.shape[1])
    out.index_put_(((rows % K_STEP) // (K_STEP // parts), rows // db),
                   u.reshape(d, 1) * w, accumulate=True)
    return out


def _planes(x, u, v=None):
    """The prologue: P (t, n) = x·û per block (Q likewise) and the norms."""
    t, d = x.shape
    n, db = u.shape
    nu = u.norm(dim=1) + 1e-8
    p = (x.view(t, n, db) * u).sum(-1) / nu
    if v is None:
        return p, nu
    nv = v.norm(dim=1) + 1e-8
    return p, nu, (x.view(t, n, db) * v).sum(-1) / nv, nv


def _out_side(y0, u2, v2):
    """H̃⁺ on the output blocks of y0 (t, k·db_out): each row's block dots
    with û2 and v̂2, then y0 − a·û2 + b·v̂2."""
    t = y0.shape[0]
    n_out, db_out = u2.shape
    uh = u2 / (u2.norm(dim=1, keepdim=True) + 1e-8)
    vh = v2 / (v2.norm(dim=1, keepdim=True) + 1e-8)
    yb = y0.view(t, n_out, db_out)
    a = (yb * uh).sum(-1, keepdim=True)
    b = (yb * vh).sum(-1, keepdim=True)
    return (yb - a * uh + b * vh).view(t, -1)


def _emulate_ep(x, w, u1, v1, u2=None, v2=None, round_to_bf16=True):
    """The wgmma route's arithmetic in float32: acc = x·W, then
    acc − p_i·U_i + q_i·V_i block by block in order (U, V from the halves
    of each K step, added in order), then two-sided H̃⁺ tile by tile on
    the fused epilogue's column tiles (each of whole output blocks) or on
    the whole row (scratch), rounded once."""
    x, w, u1, v1 = (torch.from_numpy(a) for a in (x, w, u1, v1))
    p, nu, q, nv = _planes(x, u1, v1)
    hu, hv = _parts(u1, w, 2), _parts(v1, w, 2)
    big_u = (hu[0] + hu[1]) / nu[:, None]
    big_v = (hv[0] + hv[1]) / nv[:, None]
    y = x @ w
    for i in range(u1.shape[0]):
        y = y + (-p[:, i:i + 1]) * big_u[i] + q[:, i:i + 1] * big_v[i]
    if u2 is not None:
        u2, v2 = torch.from_numpy(u2), torch.from_numpy(v2)
        n_out, db_out = u2.shape
        if ep.epilogue(n_out, db_out) == "fused":
            for c0, kept in ep.column_tiles(n_out, db_out):
                b0, nb = c0 // db_out, kept // db_out
                y[:, c0:c0 + kept] = _out_side(
                    y[:, c0:c0 + kept].clone(), u2[b0:b0 + nb],
                    v2[b0:b0 + nb])
        else:
            y = _out_side(y, u2, v2)
    if round_to_bf16:
        y = y.bfloat16().float()
    return y.numpy()


def _emulate_hh(x, w, u):
    """Row 1's arithmetic on one tile (rank 1, U in quarters), in f32."""
    p, nu = _planes(x, u)
    hu = _parts(u, w, 4)
    big_u = (((hu[0] + hu[1]) + hu[2]) + hu[3]) / nu[:, None]
    y = x @ w
    for i in range(u.shape[0]):
        y = y + (-2 * p[:, i:i + 1]) * big_u[i]
    return y


def _emulate_bank(x, w, u_bank, ids, round_to_bf16=True):
    """The bank's wgmma route: each row tile of ``batched.row_tiles`` takes
    row 1's arithmetic with its sequence's tenant's u (ids mapped into
    [0, A) as the kernels map them)."""
    b, s, d = x.shape
    a = u_bank.shape[0]
    xs = torch.from_numpy(x).reshape(b * s, d)
    w, u_bank = torch.from_numpy(w), torch.from_numpy(u_bank)
    y = torch.empty(b * s, w.shape[1])
    for row0, rows in batched.row_tiles(b, s):
        t = int(ids[row0 // s])
        t = min(max(t + a if t < 0 else t, 0), a - 1)
        y[row0:row0 + rows] = _emulate_hh(xs[row0:row0 + rows], w, u_bank[t])
    if round_to_bf16:
        y = y.bfloat16().float()
    return y.view(b, s, -1).numpy()


def _bank_inputs(b, s, d, f, n, a):
    rng = _rng(2, b, s, d, f, n, a)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    u = rng.standard_normal((a, n, d // n)).astype(np.float32)
    ids = (np.arange(b) * 2 + 1) % a
    return x, w, u, ids.astype(np.int32)


@pytest.mark.parametrize("two", [True, False])
@pytest.mark.parametrize("t,d,f,n", EP_WIDTHS)
def test_emulated_ep_route_matches_jax_bf16(t, d, f, n, two):
    x, w, u1, v1, u2, v2 = _ep_inputs(t, d, f, n)
    xb, wb = _bf16(x), _bf16(w)
    out = (u2, v2) if two else (None, None)
    want = jref.ref_etherplus_gemm(
        jnp.asarray(xb), jnp.asarray(wb), jnp.asarray(u1), jnp.asarray(v1),
        *(None if o is None else jnp.asarray(o) for o in out))
    assert _frob(_emulate_ep(xb, wb, u1, v1, *out), want) < BF16_TOL


@pytest.mark.parametrize("t,d,f,n", EP_WIDTHS)
def test_emulated_ep_route_keeps_f32_agreement(t, d, f, n):
    """Without the bf16 rounding, the rank-2 form and the tiled H̃⁺ agree
    with the updated product in f32: the JAX reference and the port's
    plain version."""
    x, w, u1, v1, u2, v2 = _ep_inputs(t, d, f, n)
    got = _emulate_ep(x, w, u1, v1, u2, v2, round_to_bf16=False)
    assert _max_err(got, jref.ref_etherplus_gemm(
        *(jnp.asarray(a) for a in (x, w, u1, v1, u2, v2)))) < F32_TOL
    assert _max_err(got, ref.ref_etherplus_gemm(
        *(torch.from_numpy(a) for a in (x, w, u1, v1, u2, v2))).numpy()
    ) < F32_TOL


@pytest.mark.parametrize("two", [True, False])
def test_emulated_ep_route_matches_interpret_pallas(two):
    t, d, f, n = 8, 256, 128, 2       # db 128, db_out 64: tileable
    x, w, u1, v1, u2, v2 = _ep_inputs(t, d, f, n)
    out = (u2, v2) if two else (None, None)
    want = etherplus_gemm_pallas(
        *(jnp.asarray(a) for a in (x, w, u1, v1)),
        *(None if o is None else jnp.asarray(o) for o in out),
        interpret=True)
    assert _max_err(_emulate_ep(x, w, u1, v1, *out, round_to_bf16=False),
                    want) < F32_TOL


@pytest.mark.parametrize("b,s,d,f,n,a", BANK_WIDTHS)
def test_emulated_bank_route_matches_jax(b, s, d, f, n, a):
    x, w, u, ids = _bank_inputs(b, s, d, f, n, a)
    xb, wb = _bf16(x), _bf16(w)
    want = jref.ref_householder_gemm_batched(
        jnp.asarray(xb), jnp.asarray(wb), jnp.asarray(u), jnp.asarray(ids))
    assert _frob(_emulate_bank(xb, wb, u, ids), want) < BF16_TOL
    f32 = _emulate_bank(x, w, u, ids, round_to_bf16=False)
    assert _max_err(f32, jref.ref_householder_gemm_batched(
        *(jnp.asarray(v) for v in (x, w, u, ids)))) < F32_TOL
    assert _max_err(f32, ref.ref_householder_gemm_batched(
        *(torch.from_numpy(v) for v in (x, w, u, ids))).numpy()) < F32_TOL


def test_emulated_bank_route_matches_interpret_pallas():
    b, s, d, f, n, a = 2, 16, 256, 128, 2, 3
    x, w, u, ids = _bank_inputs(b, s, d, f, n, a)
    want = householder_gemm_batched_pallas(
        *(jnp.asarray(v) for v in (x, w, u, ids)), interpret=True)
    assert _max_err(_emulate_bank(x, w, u, ids, round_to_bf16=False),
                    want) < F32_TOL


def test_a_bank_of_one_tenant_is_row_1_on_that_tenant():
    """Every id naming one tenant: the bank's tiles sum as row 1's, so its
    emulation equals row 1's on the tenant's u, bitwise."""
    b, s, d, f, n, a = 3, 33, 960, 40, 8, 4
    x, w, u, _ = _bank_inputs(b, s, d, f, n, a)
    ids = np.full(b, 2, np.int32)
    bank = _emulate_bank(x, w, u, ids, round_to_bf16=False)
    one = _emulate_hh(torch.from_numpy(x).reshape(b * s, d),
                      torch.from_numpy(w), torch.from_numpy(u[2]))
    assert np.array_equal(bank.reshape(b * s, f), one.numpy())


@pytest.mark.parametrize("b,s", [(4, 1), (4, 32), (4, 33), (8, 128),
                                 (2, 129), (3, 300)])
def test_bank_row_tiles_hold_one_sequence_each(b, s):
    tiles = batched.row_tiles(b, s)
    assert len(tiles) == b * -(-s // batched.TILE_ROWS)
    covered = []
    for row0, rows in tiles:
        assert 0 < rows <= batched.TILE_ROWS
        assert row0 // s == (row0 + rows - 1) // s   # one sequence
        covered += range(row0, row0 + rows)
    assert covered == list(range(b * s))


@pytest.mark.parametrize("n_out,db_out,want,nb", [
    (32, 30, "fused", 4), (32, 10, "fused", 12), (32, 80, "scratch", 0),
    (8, 120, "fused", 1), (8, 40, "fused", 3), (8, 320, "scratch", 0),
    (8, 17, "scratch", 0), (7, 17, "fused", 7), (4, 21, "fused", 4),
    (20, 12, "fused", 10), (20, 14, "fused", 8), (20, 11, "scratch", 0),
    (13, 7, "fused", 13), (None, None, "none", None)])
def test_ep_epilogue_and_tiling(n_out, db_out, want, nb):
    assert ep.epilogue(n_out, db_out) == want
    if n_out is not None:
        assert ep.blocks_per_tile(n_out, db_out) == nb


@pytest.mark.parametrize("n_out,db_out", [(32, 30), (32, 10), (8, 120),
                                          (8, 40), (7, 17), (4, 21),
                                          (20, 12), (20, 14), (13, 7)])
def test_ep_column_tiles_hold_whole_blocks_on_16_bytes(n_out, db_out):
    tiles = ep.column_tiles(n_out, db_out)
    assert tiles[0][0] == 0
    for (c0, kept), nxt in zip(tiles, tiles[1:] + [(n_out * db_out, 0)]):
        assert c0 + kept == nxt[0]               # they cover f in order
        assert c0 % db_out == 0 and kept % db_out == 0
        assert c0 % 8 == 0                       # TMA boxes on 16 bytes
        assert kept <= ep.TILE
        assert kept // db_out <= dx.MAX_BLOCKS


@pytest.mark.parametrize("dtype,d,f,n,aligned,want", [
    (torch.bfloat16, 960, 2560, 32, True, "wgmma"),
    (torch.bfloat16, 2560, 960, 32, True, "wgmma"),
    (torch.bfloat16, 960, 2560, 8, True, "wgmma"),
    (torch.bfloat16, 960, 320, 32, True, "wgmma"),
    (torch.bfloat16, 960, 2560, 64, True, "simt"),
    (torch.bfloat16, 120, 70, 8, True, "simt"),
    (torch.bfloat16, 960, 2560, 32, False, "simt"),
    (torch.float32, 960, 2560, 32, True, "simt"),
])
def test_ep_route_rule(dtype, d, f, n, aligned, want):
    assert ep.route(dtype, d, f, n, aligned) == want


@pytest.mark.parametrize("dtype,d,f,n,aligned", [
    (torch.bfloat16, 960, 2560, 32, True), (torch.bfloat16, 960, 2560, 33,
                                            True),
    (torch.bfloat16, 964, 2560, 4, True), (torch.bfloat16, 960, 2564, 4,
                                           True),
    (torch.bfloat16, 960, 2560, 8, False), (torch.float32, 960, 2560, 8,
                                            True),
])
def test_the_three_wgmma_rules_share_one_test(dtype, d, f, n, aligned):
    takes = hh.wgmma_takes(dtype, d, f, n, aligned)
    assert takes == (dtype == torch.bfloat16 and n <= 32 and d % 8 == 0
                     and f % 8 == 0 and aligned)
    assert ep.route(dtype, d, f, n, aligned) == batched.gemm_route(
        dtype, d, f, n, aligned) == ("wgmma" if takes else "simt")
    assert hh.route(dtype, 1024, d, f, n, aligned) == (
        "wgmma" if takes else "simt")


@pytest.mark.parametrize("dtype,d,f,n,aligned,want", [
    (torch.bfloat16, 960, 2560, 32, True, "wgmma"),
    (torch.bfloat16, 2560, 960, 8, True, "wgmma"),
    (torch.bfloat16, 960, 2560, 64, True, "simt"),
    (torch.bfloat16, 120, 70, 8, True, "simt"),
    (torch.bfloat16, 960, 2560, 8, False, "simt"),
    (torch.float32, 960, 2560, 8, True, "simt"),
])
def test_bank_route_rule(dtype, d, f, n, aligned, want):
    assert batched.gemm_route(dtype, d, f, n, aligned) == want


def test_cpu_calls_count_no_launch_and_no_route():
    x, w, u1, v1, u2, v2 = (torch.from_numpy(a).contiguous()
                            for a in _ep_inputs(4, 960, 320, 32))
    xb, wb, ub, ids = (torch.from_numpy(a) for a in
                       _bank_inputs(2, 3, 960, 40, 8, 3))
    ops.reset_launches()
    ops.etherplus_gemm(x.bfloat16(), w.bfloat16(), u1, v1, u2, v2)
    ops.householder_gemm_batched(xb.bfloat16(), wb.bfloat16(), ub, ids)
    for op, routes in (("etherplus_gemm", ep.ROUTES),
                       ("householder_gemm_batched", batched.GEMM_ROUTES)):
        assert set(ops.routes(op)) == {f"{op}.{r}" for r in routes}
        assert set(ops.routes(op).values()) == {0}
        assert ops.launches()[op] == 0
