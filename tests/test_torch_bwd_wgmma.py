"""The dXr backwards' routes, tile plan and wgmma arithmetic on the CPU:
``reflect_gemm_dx`` (rank 1 and ETHER+'s rank 2) and
``householder_gemm_batched_bwd``.

The wgmma route computes dXr = G·Wᵀ on the tensor cores: exact products
of the stored bf16 G and W summed in f32, 16 along f at a time in order.
Where a reflection block fits a 128- or 160-column tile, column tiles
hold whole blocks and the reflection backward runs on the f32
accumulators: per
block the dots ûᵀdXr_t and ûᵀx_t, dx = dXr + c_u (ûᵀdXr_t) û [+ c_v
(v̂ᵀdXr_t) v̂] rounded once, and ĝ's partial over each 128-row tile,
the partials then summed in order and put through the ε-norm chain; a
bank's row tiles lie inside one sequence and take its tenant's
hyperplanes, an id outside [0, A) mapped as the forward maps it.  Wider
blocks take the same GEMM into an f32 scratch and the reflection
backward kernel's 32-row tiles.  ``_emulate`` repeats that arithmetic
here, in this file alone, and the tests hold it against the JAX package
on the same seeded numpy inputs: ``repro.kernels.ref``'s backwards (and
``_bank_grad`` after the per-sequence ĝ), and ``reflect_gemm_dx_pallas``
in interpret mode, at the main paths' block widths (db 30, 80, 120, 128,
344) with small T and f and ragged T and S.  The CUDA kernels run on the
card (tests/test_torch_cuda_bwd.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.gemm_bwd import reflect_gemm_dx_pallas
from repro.kernels.ops import _bank_grad
from repro_torch.kernels import batched
from repro_torch.kernels import ops, ref
from repro_torch.kernels import reflect_gemm_dx as kdx

# bf16: dx rounded once on the kernel's side, normalised max error; du:
# the same f32 math in another order of the sums, relative Frobenius;
# float32 against interpret Pallas, normalised max error
BF16_TOL, DU_TOL, F32_TOL = 1e-2, 1e-4, 1e-5
N_STEP = 16           # the f a wgmma instruction sums (k16)
FUSED_ROWS, SCRATCH_ROWS = kdx.TILE_ROWS, 32   # rows of a ĝ partial
WGMMA_MAX_N = 256     # the widest product wgmma has
EPS = 1e-8
# the JAX references, compiled once a shape
J_HH_BWD = jax.jit(jref.ref_householder_gemm_bwd)
J_EP_BWD = jax.jit(lambda x, w, u, v, g: jref.ref_etherplus_gemm_bwd(
    x, w, u, v, None, None, g)[:4])
J_BANK_BWD = jax.jit(jref.ref_householder_gemm_batched_bwd)
J_BANK_GRAD = jax.jit(_bank_grad)
# (t, n, db, f): the main paths' block widths at small T and f, T ragged
# against the 128-row tiles
WIDTHS = [(130, 5, 30, 24), (70, 3, 80, 16), (129, 2, 120, 40),
          (5, 2, 128, 32), (33, 2, 344, 16)]
# (B, S) of a bank: decode, a ragged and a 128-row sequence, one longer
BANKS = [(3, 1), (2, 100), (2, 128), (2, 130)]


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()


def _inputs(seed, t, d, f, n, tenants=None):
    """x (t, d), w (d, f), g (t, f) bf16-representable, as float32; u (n,
    d/n) raw f32, or (tenants, n, d/n) for a bank."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((t, d)))
    w = _bf16(rng.standard_normal((d, f)) / np.sqrt(d))
    g = _bf16(rng.standard_normal((t, f)))
    shape = (n, d // n) if tenants is None else (tenants, n, d // n)
    u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x, w, g, u


def _dxr(g, w):
    """The tensor cores' dXr: exact products summed in f32, N_STEP of f
    at a time in order."""
    acc = torch.zeros(g.shape[0], w.shape[0])
    for k in range(0, g.shape[1], N_STEP):
        acc = acc + g[:, k:k + N_STEP] @ w[:, k:k + N_STEP].T
    return acc


def _tiles(n, db):
    """The column tiles of the wgmma route as (first block, blocks) where
    they hold whole blocks; under the scratch epilogue the reflection
    kernel takes one block at a time."""
    if kdx.epilogue(n, db) == "scratch":
        return [(i, 1) for i in range(n)]
    return [(k0 // db, width // db) for k0, width in kdx.column_tiles(n, db)]


def _unit(u):
    return u / (u.norm(dim=-1, keepdim=True) + EPS)


def _norm_chain(u, ghat):
    r = u.norm(dim=-1, keepdim=True)
    s = r + EPS
    return ghat / s - (u * ghat).sum(-1, keepdim=True) * u / (r * s * s)


def _emulate(x, w, g, u, v=None, seq=None, tenant=None, fused=None):
    """The route's arithmetic: dXr, then per row tile (``seq`` rows a
    sequence, each with its own tiles; ``tenant[b]`` its hyperplanes'
    row of a bank u) and column tile the dots, dx and ĝ's partial; dx
    rounded once to bf16.  Returns (dx, ĝ_u partial rows, ĝ_v's or None,
    the tiles' sequences)."""
    t, d = x.shape
    n = u.shape[-2]
    db = d // n
    fused = kdx.epilogue(n, db) == "fused" if fused is None else fused
    rows_a_tile = FUSED_ROWS if fused else SCRATCH_ROWS
    cu, cv = (-2.0, None) if v is None else (-1.0, 1.0)
    seq = t if seq is None else seq
    dxr = _dxr(g, w).view(t, n, db)
    xb = x.view(t, n, db)
    dx = torch.empty(t, n, db)
    parts_u, parts_v, owner = [], [], []
    for s0 in range(0, t, seq):
        b = s0 // seq
        uu = u if tenant is None else u[tenant[b]]
        dirs = [(_unit(uu), cu, parts_u)]
        if v is not None:
            dirs.append((_unit(v), cv, parts_v))
        for r0 in range(s0, s0 + seq, rows_a_tile):
            rows = slice(r0, min(r0 + rows_a_tile, s0 + seq))
            owner.append(b)
            out = dxr[rows].clone()
            tile_g = [torch.zeros(n, db) for _ in dirs]
            for i0, blocks in _tiles(n, db):
                blk = slice(i0, i0 + blocks)
                for (uh, c, _), gh in zip(dirs, tile_g):
                    px = (xb[rows, blk] * uh[blk]).sum(-1, keepdim=True)
                    pg = (dxr[rows, blk] * uh[blk]).sum(-1, keepdim=True)
                    gh[blk] = c * (px * dxr[rows, blk]
                                   + pg * xb[rows, blk]).sum(0)
                    out[:, blk] = out[:, blk] + c * pg * uh[blk]
            dx[rows] = out
            for (_, _, parts), gh in zip(dirs, tile_g):
                parts.append(gh)
    return (dx.view(t, d).bfloat16().float(), parts_u,
            parts_v if v is not None else None, owner)


def _in_order(parts):
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _frob(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _j(*arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


def _id_map(ids, tenants):
    """The forward's map of an id into [0, A): a negative id counts from
    the end, then the id is clamped."""
    return [min(max(i + tenants if i < 0 else i, 0), tenants - 1)
            for i in ids]


# --- the route rule and the tile plan -------------------------------------

@pytest.mark.parametrize("pick", [kdx.route, batched.route])
@pytest.mark.parametrize("dtype,t,d,f,n,aligned,want", [
    (torch.bfloat16, 1024, 960, 2560, 32, True, "wgmma"),
    (torch.bfloat16, 1000, 2560, 960, 32, True, "wgmma"),
    (torch.bfloat16, 4, 960, 320, 8, True, "wgmma"),
    (torch.bfloat16, 4096, 11008, 4096, 32, True, "wgmma"),
    (torch.bfloat16, 40, 96, 256, 32, True, "wgmma"),
    (torch.bfloat16, 4, 120, 70, 8, True, "simt"),
    (torch.bfloat16, 4, 100, 64, 4, True, "simt"),
    (torch.bfloat16, 1024, 960, 2560, 32, False, "simt"),
    (torch.float32, 1024, 960, 2560, 32, True, "simt"),
    (torch.float32, 4096, 4096, 11008, 32, True, "simt"),
])
def test_route_rule(pick, dtype, t, d, f, n, aligned, want):
    assert pick(dtype, t, d, f, n, d // n, aligned) == want


@pytest.mark.parametrize("n,db,width", [
    (32, 30, 128), (32, 80, 160), (8, 120, 128), (32, 128, 128),
    (5, 30, 128), (3, 121, 128), (32, 3, 128), (8, 12, 128), (1, 80, 128),
    (2, 129, 160), (4, 150, 160), (8, 320, 0), (32, 344, 0), (8, 1376, 0),
    (2, 161, 0)])
def test_tile_plan(n, db, width):
    """Every block lies in exactly one column tile, no tile is wider than
    the widest wgmma product, and the plan is whole blocks or scratch by
    db alone: the tile width whose whole blocks fill the most of it."""
    d = n * db
    tiles = kdx.column_tiles(n, db)
    assert kdx.tile_width(n, db) == width
    assert kdx.epilogue(n, db) == ("fused" if width else "scratch") == (
        "fused" if db <= max(kdx.TILES) else "scratch")
    assert all(0 < kept <= max(width, kdx.TILES[0]) <= WGMMA_MAX_N
               for _, kept in tiles)
    covered = np.zeros(d, int)
    for k0, kept in tiles:
        covered[k0:k0 + kept] += 1
    assert (covered == 1).all()
    if width:
        assert all(k0 % db == 0 and kept % db == 0 for k0, kept in tiles)
        nb = kdx.blocks_per_tile(n, db)
        assert nb == min(n, width // db, kdx.MAX_BLOCKS)
        assert len(tiles) == -(-n // nb)
        for i in range(n):   # each block in one tile, whole
            assert sum(k0 <= i * db and (i + 1) * db <= k0 + kept
                       for k0, kept in tiles) == 1
        # no other width fills more of its tile
        assert all(min(n, w // db, kdx.MAX_BLOCKS) * db / w
                   <= nb * db / width for w in kdx.TILES)
    else:
        assert kdx.blocks_per_tile(n, db) == 0
        assert [k0 for k0, _ in tiles] == list(range(0, d, kdx.TILES[0]))


def test_smollm_train_widths_fuse_and_llama_down_takes_scratch():
    """Phase 4's blocks (n = 32 on d = 960 and 2560) and Llama-2-7B's d =
    4096 fuse; its down_proj's d = 11008 (db 344) and smollm-360m's
    d = 2560 at n = 8 (db 320) take the scratch epilogue."""
    assert [kdx.epilogue(32, d // 32) for d in (960, 2560, 4096, 11008)] \
        == ["fused", "fused", "fused", "scratch"]
    assert kdx.epilogue(8, 2560 // 8) == "scratch"
    assert kdx.blocks_per_tile(32, 30) == 4          # 120 of 128 columns
    assert kdx.blocks_per_tile(32, 80) == 2          # 160 of 160 columns


# --- the emulated arithmetic against the JAX package ----------------------

@pytest.mark.parametrize("t,n,db,f", WIDTHS)
def test_emulated_rank1_matches_jax(t, n, db, f):
    d = n * db
    x, w, g, u = _inputs(t + db, t, d, f, n)
    dx, parts, _, _ = _emulate(x, w, g, u)
    du = _norm_chain(u, _in_order(parts))
    jdx, _, jdu = J_HH_BWD(*_j(x, w, u, g))
    assert _max_err(dx, jdx) < BF16_TOL
    assert _frob(du, jdu) < DU_TOL


@pytest.mark.parametrize("t,n,db,f", WIDTHS)
def test_emulated_rank2_matches_jax(t, n, db, f):
    """ETHER+'s one-sided backward (the rank-2 shim), v drawn apart from
    u: c_u = −1 and c_v = +1."""
    d = n * db
    x, w, g, u = _inputs(3 * t + db, t, d, f, n)
    v = u + 0.5 * torch.from_numpy(np.random.default_rng(t).standard_normal(
        u.shape).astype(np.float32))
    dx, pu, pv, _ = _emulate(x, w, g, u, v)
    jdx, _, jdu, jdv = J_EP_BWD(*_j(x, w, u, v, g))
    assert _max_err(dx, jdx) < BF16_TOL
    assert _frob(_norm_chain(u, _in_order(pu)), jdu) < DU_TOL
    assert _frob(_norm_chain(v, _in_order(pv)), jdv) < DU_TOL


@pytest.mark.parametrize("t,n,db,f", WIDTHS[:2] + WIDTHS[-1:])
def test_both_epilogues_agree(t, n, db, f):
    """The fused and the scratch epilogue are the same math on the same
    dXr: dx bitwise equal, du to the sum order's rounding."""
    d = n * db
    x, w, g, u = _inputs(5 * t, t, d, f, n)
    a = _emulate(x, w, g, u, fused=True)
    b = _emulate(x, w, g, u, fused=False)
    assert torch.equal(a[0], b[0])
    assert _frob(_norm_chain(u, _in_order(a[1])),
                 _norm_chain(u, _in_order(b[1]))) < DU_TOL


@pytest.mark.parametrize("b,s", BANKS)
@pytest.mark.parametrize("n,db", [(4, 30), (2, 80), (2, 344)])
def test_emulated_bank_matches_jax(b, s, n, db):
    """Row tiles per sequence with the sequence's tenant's hyperplanes
    (ids with a repeat): dx and du_bank against the JAX reference, and
    the per-sequence ĝ through the JAX op's ``_bank_grad``."""
    d, f, tenants = n * db, 24, 6
    x, w, g, u = _inputs(b * s + db, b * s, d, f, n, tenants)
    ids = [4, 1, 4][:b]
    dx, parts, _, owner = _emulate(x, w, g, u, seq=s, tenant=ids)
    ghat = torch.stack([_in_order([p for p, o in zip(parts, owner) if o == i])
                        for i in range(b)])
    jdx, _, jdu, _ = J_BANK_BWD(
        *_j(x.view(b, s, d), w, u, np.array(ids, np.int32),
            g.view(b, s, f)))
    assert _max_err(dx.view(b, s, d), jdx) < BF16_TOL
    assert _frob(J_BANK_GRAD(*_j(u, np.array(ids, np.int32), ghat)),
                 jdu) < DU_TOL
    du = torch.zeros_like(u)
    for a in range(tenants):
        mine = [ghat[i] for i in range(b) if ids[i] == a]
        if mine:
            du[a] = _norm_chain(u[a], _in_order(mine))
    assert _frob(du, jdu) < DU_TOL
    assert not du[[a for a in range(tenants) if a not in ids]].any()


def test_emulated_bank_maps_ids_as_the_forward():
    """Ids outside [0, A) land on the tenants the forward serves them
    with (a negative id counts from the end, then the id is clamped),
    which the JAX reference's scatter-add drops (ROADMAP Queue 3): held
    against JAX on the ids mapped first."""
    b, s, n, db, f, tenants = 4, 100, 4, 30, 16, 6
    d = n * db
    x, w, g, u = _inputs(11, b * s, d, f, n, tenants)
    raw = [7, -1, 2, -9]
    mapped = _id_map(raw, tenants)
    assert mapped == [5, 5, 2, 0]
    dx, parts, _, owner = _emulate(x, w, g, u, seq=s, tenant=mapped)
    ghat = torch.stack([_in_order([p for p, o in zip(parts, owner) if o == i])
                        for i in range(b)])
    jdx, _, jdu, _ = J_BANK_BWD(
        *_j(x.view(b, s, d), w, u, np.array(mapped, np.int32),
            g.view(b, s, f)))
    assert _max_err(dx.view(b, s, d), jdx) < BF16_TOL
    assert _frob(J_BANK_GRAD(*_j(u, np.array(mapped, np.int32), ghat)),
                 jdu) < DU_TOL
    # the port's plain version maps the raw ids the same way
    pdx, pgh = ref.ref_householder_gemm_batched_bwd(
        x.view(b, s, d), w, u, torch.tensor(raw), g.view(b, s, f))
    assert _frob(ghat, pgh) < DU_TOL
    assert _max_err(dx.view(b, s, d), pdx.float()) < BF16_TOL


def test_emulated_route_matches_interpret_pallas():
    """Without the bf16 rounding, the route's f32 arithmetic against the
    Pallas kernel in interpret mode (db 128: whole K blocks for it)."""
    t, n, db, f = 16, 2, 128, 128
    d = n * db
    x, w, g, u = _inputs(3, t, d, f, n)
    t_, d_ = x.shape
    dxr = _dxr(g, w).view(t_, n, db)
    uh = _unit(u)
    pg = (dxr * uh).sum(-1, keepdim=True)
    want_dx, want_du = reflect_gemm_dx_pallas(*_j(x, w, u, g),
                                              interpret=True)
    assert _max_err((dxr - 2 * pg * uh).view(t_, d_), want_dx) < F32_TOL
    _, parts, _, _ = _emulate(x, w, g, u)
    assert _frob(_norm_chain(u, _in_order(parts)), want_du) < DU_TOL


@pytest.mark.parametrize("t,n,db,f", WIDTHS[:3])
def test_emulated_route_matches_the_plain_version(t, n, db, f):
    """The port's plain version (``chip_smoke.py`` holds the kernel to it
    on the card) agrees with the emulated route."""
    d = n * db
    x, w, g, u = _inputs(7 * t, t, d, f, n)
    dx, parts, _, _ = _emulate(x, w, g, u)
    pdx, pdu = ref.ref_reflect_gemm_dx(x.bfloat16(), w.bfloat16(), u,
                                       g.bfloat16())
    assert _max_err(dx, pdx.float()) < BF16_TOL
    assert _frob(_norm_chain(u, _in_order(parts)), pdu) < DU_TOL


def test_cpu_calls_count_no_launch_and_no_route():
    t, n, db, f = 6, 4, 24, 16
    d = n * db
    x, w, g, u = _inputs(1, t, d, f, n)
    xb, wb, gb = x.bfloat16(), w.bfloat16(), g.bfloat16()
    ops.reset_launches()
    ops.householder_gemm_bwd(xb, wb, u, gb, need_dw=False)
    ops.etherplus_gemm_bwd(xb, wb, u, u.flip(0), None, None, gb,
                           need_dw=False)
    ops.householder_gemm_batched_bwd(
        xb.view(2, 3, d), wb, u.expand(3, n, db).contiguous(),
        torch.tensor([0, 2]), gb.view(2, 3, f), need_dw=False)
    for op in ("reflect_gemm_dx", "householder_gemm_batched_bwd"):
        assert set(ops.routes(op)) == {f"{op}.{r}" for r in kdx.ROUTES}
        assert set(ops.routes(op).values()) == {0}
        assert ops.launches()[op] == 0
