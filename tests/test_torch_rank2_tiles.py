"""The ETHER+ bank reflections' tile kernels (csrc/rank2_tiles.cuh: rows 7
and 25), their arithmetic emulated on the CPU and held against the JAX
package.

The CUDA kernels run only on the card.  This file repeats their sums in
the order the header's note states (a block's norm and each (row, block)
pair's projections in 32 lane chains and the xor butterfly, the norm
formed once; out and dx as two fmaf; each tile's ĝ partial over its rows
in order, then the tiles of a sequence, then the sequences of a tenant,
then the norm chain), with the tile rows the port's rule picks
(``batched.rank2_geometry``), fmaf emulated in float64 and rounded once.  The emulation is held against
``repro.kernels.ref`` and, at a few shapes, the interpret-mode Pallas
kernels ``etherplus_reflect_batched_pallas`` and
``etherplus_reflect_batched_bwd_pallas`` with the JAX op's ``_bank_grad``,
on seeded numpy inputs: d ∈ {320, 960, 2560} × n ∈ {8, 32} (db 10-320),
S ∈ {1, 33, 100, 128} (``SHAPES``), ids with a repeat, A − 1 and one id ≥ A (handed
to the JAX package mapped into [0, A), as the kernels map it).  The rule
for the tile rows, chunks and 16-byte loads is tested here too.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.etherplus_reflect_batched import \
    etherplus_reflect_batched_pallas
from repro.kernels.reflect_bwd_batched import \
    etherplus_reflect_batched_bwd_pallas
from repro_torch.kernels import batched as kb
from repro_torch.kernels import ref

A = 7
IDS = [5, A - 1, 5, A + 2]          # a repeat, A − 1, one id ≥ A
B = len(IDS)
WIDTHS = [(320, 8), (320, 32), (960, 8), (960, 32), (2560, 8), (2560, 32)]
# (d, n, S): every width at a ragged S, then S ∈ {1, 100, 128} at two
# widths (the product of all of them would take the file past its time)
SHAPES = ([(d, n, 33) for d, n in WIDTHS]
          + [(d, n, s) for d, n in ((960, 32), (2560, 8))
             for s in (1, 100, 128)])
# float32: max |a − b| / max |b|, the same f32 math in another order
F32_TOL = 1e-5
# bf16: relative Frobenius, the kernel's f32 result rounded once
BF16_TOL = 1e-2
# ĝ, du, dv: relative Frobenius (chip_smoke.py's DU_TOL)
DU_TOL = 1e-4
EPS = 1e-8


# ---------------------------------------------------------------------------
# The kernels' arithmetic, in the order of csrc/rank2_tiles.cuh
# ---------------------------------------------------------------------------

def fma(a, b, c):
    """fmaf: a·b + c rounded once to float32 (the product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def lane_sums(terms, lanes):
    """Σ over the last axis as ``lanes`` lanes sum it: lane l takes
    elements l, l + lanes, ... in a chain from 0 (``terms`` a pair of
    factors, multiplied by fma), then the xor butterfly."""
    a, b = terms
    k = -(-a.shape[-1] // lanes)
    pad = k * lanes - a.shape[-1]
    a = torch.nn.functional.pad(a, (0, pad)).reshape(*a.shape[:-1], k, lanes)
    b = torch.nn.functional.pad(b, (0, pad)).reshape(*b.shape[:-1], k, lanes)
    s = torch.zeros(a.shape[:-2] + (lanes,))
    for i in range(k):
        s = fma(a[..., i, :], b[..., i, :], s)
    lane = torch.arange(lanes)
    off = lanes // 2
    while off:
        s = s + s[..., lane ^ off]
        off //= 2
    return s[..., 0]


def hats(bank, tenants):
    """û (B, n, db) of each sequence's tenant: the norm by one warp."""
    u = bank[tenants]
    nrm = torch.sqrt(lane_sums((u, u), 32)) + EPS
    return u / nrm[..., None]


def emulate_forward(x, u_bank, v_bank, ids):
    b, s, d = x.shape
    _, n, db = u_bank.shape
    t = ref.bank_index(ids, u_bank.shape[0])
    uh, vh = hats(u_bank, t), hats(v_bank, t)
    xb = x.float().reshape(b, s, n, db)
    pu = lane_sums((xb, uh[:, None].expand_as(xb)), 32)[..., None]
    pv = lane_sums((xb, vh[:, None].expand_as(xb)), 32)[..., None]
    out = fma(pv, vh[:, None], fma(-pu, uh[:, None], xb))
    return out.reshape(b, s, d).to(x.dtype)


def emulate_backward(x, u_bank, v_bank, ids, g, rows):
    """(dx, ĝu_seq, ĝv_seq, du_bank, dv_bank) with tiles of ``rows``."""
    b, s, d = x.shape
    a_n, n, db = u_bank.shape
    t = ref.bank_index(ids, a_n)
    uh, vh = hats(u_bank, t), hats(v_bank, t)
    xb = x.float().reshape(b, s, n, db)
    gb = g.float().reshape(b, s, n, db)

    def proj(y, h):
        return lane_sums((y, h[:, None].expand_as(y)), 32)[..., None]
    px, pg, qx, qg = proj(xb, uh), proj(gb, uh), proj(xb, vh), proj(gb, vh)
    dx = fma(qg, vh[:, None], fma(-pg, uh[:, None], gb))
    # each tile's partial over its rows in order, then the tiles in order
    tiles = -(-s // rows)
    ghat = []
    for p1, p2 in ((px, pg), (qx, qg)):
        acc = torch.zeros(b, tiles, n, db)
        for r in range(rows):
            idx = torch.arange(tiles) * rows + r
            live = idx < s
            i = idx.clamp(max=s - 1)
            new = acc + fma(p1[:, i], gb[:, i], p2[:, i] * xb[:, i])
            acc = torch.where(live[None, :, None, None], new, acc)
        seq = torch.zeros(b, n, db)
        for j in range(tiles):
            seq = seq + acc[:, j]
        ghat.append(seq)
    ghat[0] = -ghat[0]
    grads = []
    for bank, gh in ((u_bank, ghat[0]), (v_bank, ghat[1])):
        out = torch.zeros(a_n, n, db)
        for a in range(a_n):
            hit = [i for i in range(b) if t[i] == a]
            if not hit:
                continue
            gs = torch.zeros(n, db)
            for i in hit:
                gs = gs + gh[i]
            ua = bank[a]
            rn = torch.sqrt(lane_sums((ua, ua), 32))[:, None]
            dot = lane_sums((ua, gs), 32)[:, None]
            sn = rn + EPS
            out[a] = gs / sn - (dot * ua) / ((rn * sn) * sn)
        grads.append(out)
    return (dx.reshape(b, s, d).to(x.dtype), ghat[0], ghat[1], *grads)


# ---------------------------------------------------------------------------
# Operands and measures
# ---------------------------------------------------------------------------

def operands(seed, s, d, n):
    """x and G (values a bf16 holds, so that one float32 reference serves
    both dtypes), the banks and the ids, as numpy."""
    rng = np.random.default_rng(seed)
    db = d // n

    def act():
        a = rng.standard_normal((B, s, d)).astype(np.float32)
        return torch.from_numpy(a).bfloat16().float().numpy()
    x, g = act(), act()
    u = rng.standard_normal((A, n, db)).astype(np.float32)
    v = rng.standard_normal((A, n, db)).astype(np.float32)
    return x, g, u, v


def port(ops_np, dtype):
    """(x, u_bank, v_bank, ids, g) as the port takes them."""
    x, g, u, v = ops_np
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(u),
            torch.from_numpy(v), torch.tensor(IDS, dtype=torch.int32),
            torch.from_numpy(g).to(dtype))


def mapped_ids():
    return np.asarray(ref.bank_index(torch.tensor(IDS), A).numpy(),
                      dtype=np.int32)


@jax.jit
def _jax_ref(x, u, v, ids, g):
    out, back = jax.vjp(jref.ref_etherplus_reflect_batched, x, u, v, ids)
    dx, du, dv, _ = back(g)
    return out, dx, du, dv


@functools.lru_cache(maxsize=None)
def case(d, n, s):
    """The operands of one shape and ``repro.kernels.ref``'s (out, dx,
    du_bank, dv_bank) on them, in float32, the ids mapped into [0, A)."""
    x, g, u, v = operands(d + n + s, s, d, n)
    want = [np.asarray(a) for a in _jax_ref(x, u, v, mapped_ids(), g)]
    return (x, g, u, v), want


def max_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def frob(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def f64(t):
    return t.double().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float64)


def check(got, want, dtype):
    if dtype == torch.float32:
        assert max_err(f64(got), f64(want)) <= F32_TOL
    else:
        assert frob(f64(got), f64(want)) <= BF16_TOL


# ---------------------------------------------------------------------------
# The emulation against the JAX package
# ---------------------------------------------------------------------------

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])


@DTYPES
@pytest.mark.parametrize("d,n,s", SHAPES)
def test_forward_tiles_match_jax_ref(d, n, s, dtype):
    operands_np, (want, *_) = case(d, n, s)
    x, u, v, ids, _ = port(operands_np, dtype)
    got = emulate_forward(x, u, v, ids)
    assert got.dtype == dtype and got.shape == x.shape
    check(got, want, dtype)


@DTYPES
@pytest.mark.parametrize("d,n,s", SHAPES)
def test_backward_tiles_match_jax_ref(d, n, s, dtype):
    operands_np, (_, jdx, jdu, jdv) = case(d, n, s)
    x, u, v, ids, g = port(operands_np, dtype)
    rows = kb.rank2_geometry(B, s, n, d // n, x.element_size(), True,
                             True)[0]
    dx, gu, gv, du, dv = emulate_backward(x, u, v, ids, g, rows)
    check(dx, jdx, dtype)
    assert frob(f64(du), jdu) <= DU_TOL
    assert frob(f64(dv), jdv) <= DU_TOL
    # ĝ_seq: the port's plain version (held to the interpret-mode Pallas
    # kernel by test_torch_bank_train.py and below)
    _, pgu, pgv = ref.ref_etherplus_reflect_batched_bwd(x, u, v, ids, g)
    assert frob(f64(gu), f64(pgu)) <= DU_TOL
    assert frob(f64(gv), f64(pgv)) <= DU_TOL
    # the tenants that no id names: exactly zero
    named = set(mapped_ids().tolist())
    for grad in (du, dv):
        assert [bool(grad[a].abs().max() > 0) for a in range(A)] == \
            [a in named for a in range(A)]
        assert all(torch.equal(grad[a], torch.zeros_like(grad[a]))
                   for a in range(A) if a not in named)


@DTYPES
def test_tiles_match_interpret_pallas(dtype):
    d, n, s = (320, 32, 33) if dtype == torch.float32 else (320, 8, 33)
    operands_np, _ = case(d, n, s)
    x, u, v, ids, g = port(operands_np, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jg = (jnp.asarray(a).astype(jdt) for a in (operands_np[0],
                                                    operands_np[1]))
    ju, jv, jids = operands_np[2], operands_np[3], mapped_ids()
    want = etherplus_reflect_batched_pallas(jx, ju, jv, jids, interpret=True)
    check(emulate_forward(x, u, v, ids), want, dtype)
    rows = kb.rank2_geometry(B, s, n, d // n, x.element_size(), True,
                             True)[0]
    dx, gu, gv, du, dv = emulate_backward(x, u, v, ids, g, rows)
    jdx, jgu, jgv = etherplus_reflect_batched_bwd_pallas(
        jx, ju, jv, jids, jg, interpret=True)
    check(dx, jdx, dtype)
    assert frob(f64(gu), jgu) <= DU_TOL and frob(f64(gv), jgv) <= DU_TOL
    assert frob(f64(du), jops._bank_grad(ju, jids, jgu)) <= DU_TOL
    assert frob(f64(dv), jops._bank_grad(jv, jids, jgv)) <= DU_TOL


@pytest.mark.parametrize("rows", [1, 4, 32])
def test_tile_rows_change_only_the_sum_order(rows):
    """Any tile rows give ĝ within rounding of the plain version's (the
    tiles split a sequence's sum, nothing else)."""
    x, u, v, ids, g = port(case(960, 32, 100)[0], torch.float32)
    dx, gu, gv, du, dv = emulate_backward(x, u, v, ids, g, rows)
    pdx, pgu, pgv = ref.ref_etherplus_reflect_batched_bwd(x, u, v, ids, g)
    assert max_err(f64(dx), f64(pdx)) <= F32_TOL
    assert frob(f64(gu), f64(pgu)) <= DU_TOL
    assert frob(f64(gv), f64(pgv)) <= DU_TOL


def test_emulation_repeats_the_norm_of_rank2_rows_kernel():
    """û is u over one warp's norm: the lane chains and butterfly give the
    norm within one rounding of the plain one."""
    u = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (A, 32, 80)).astype(np.float32))
    got = hats(u, torch.arange(A))
    assert max_err(f64(got), f64(ref.unit(u))) <= 1e-6


# ---------------------------------------------------------------------------
# The host's rule for the tiles (kernels/batched.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,rows,bpc", [(8, 128, 4, 32), (16, 128, 8, 32),
                                          (4, 1, 1, 4), (4, 33, 1, 32),
                                          (4, 100, 2, 32), (64, 1, 1, 12)])
def test_forward_tiles_fill_the_card(b, s, rows, bpc):
    """The forward's rows: the largest power of two (≤ 32, ≤ S) whose
    tiles still fill the 132 SMs, then the most blocks a chunk that keeps
    them full: phase 14's train shape (8 × 128) takes 4 rows, 256 CTAs;
    decode one row, its 4 sequences cut into chunks of 4 blocks."""
    n, db = 32, 30
    got = kb.rank2_geometry(b, s, n, db, 2, False, True)
    assert got == (rows, bpc, 1, 1)
    ctas = b * -(-s // rows) * -(-n // bpc)
    assert ctas >= kb.SMS or bpc == min(kb._chunk_sizes(n, db, 8))
    assert b * -(-s // (2 * rows)) < kb.SMS or 2 * rows > min(s, 32)


@pytest.mark.parametrize("b,s,n,db,rows,bpc", [
    (8, 128, 32, 30, 32, 4), (8, 128, 32, 10, 32, 4), (8, 128, 32, 80, 32, 7),
    (16, 128, 8, 320, 32, 2), (4, 1, 8, 120, 1, 1), (4, 33, 8, 40, 32, 1),
    (4, 100, 32, 80, 32, 3)])
def test_backward_tiles_keep_32_rows(b, s, n, db, rows, bpc):
    """The backward's tiles are the per-row kernel's 32 rows (S where
    fewer), whose ĝ partials it summed; chunks fill the card: phase 14's
    8 × 128 at n 32 takes 4 blocks a chunk at db 30 (8 chunks, 256 CTAs,
    each on 16 bytes) and 7 at db 80 (5 chunks, 160 CTAs)."""
    got = kb.rank2_geometry(b, s, n, db, 2, True, True)
    assert got == (rows, bpc, 1, 1)
    assert bpc * db % 8 == 0


def test_tiles_bounded_by_shared_memory():
    """The forward's rows stop where the tiles would no longer fill the
    card (16 × 128 at 2560 wide: 8 rows, 256 CTAs) or where a tile would
    pass TILE_SMEM (Llama-2-7B's 11008 in f32, chunks of 2 blocks of 1376:
    4 rows, where 8 would still fill the card); a backward tile
    of 32 rows of 1376 (Llama-2-7B's down_proj at n 8) takes one block
    past TILE_SMEM, staged all the same."""
    assert kb.rank2_geometry(16, 128, 8, 320, 2, False, True) == (8, 8, 1, 1)
    assert kb.rank2_geometry(16, 128, 8, 1376, 4, False, True) == (4, 2, 1, 1)
    assert kb._tile_smem(8, 2, 1376, 4, False, True) > kb.TILE_SMEM
    assert kb.rank2_geometry(8, 128, 8, 1376, 2, True, True) == (32, 1, 1, 1)
    assert kb._tile_smem(32, 1, 1376, 2, True, True) > kb.TILE_SMEM


@pytest.mark.parametrize("d,n,es,aligned,vec",
                         [(960, 32, 2, True, 1), (104, 8, 2, True, 1),
                          (100, 4, 2, True, 0), (96, 8, 4, True, 1),
                          (90, 3, 4, True, 0), (960, 32, 2, False, 0)])
def test_sixteen_byte_loads_where_rows_start_on_16_bytes(d, n, es, aligned,
                                                         vec):
    """d not a multiple of 16 bytes, or x off 16 bytes: the same kernel,
    element by element."""
    for bwd in (False, True):
        assert kb.rank2_geometry(4, 3, n, d // n, es, bwd,
                                 aligned)[2] == vec


def test_wide_rows_cut_into_chunks_of_whole_blocks():
    """Llama-2-7B's 11008 wide at n 32 (db 344): chunks of whole blocks on
    16 bytes, at most CHUNK_COLS wide; one block of 27648 in f32 does not
    fit a staged tile and streams; 60000 does not fit at all."""
    assert kb._chunk_sizes(32, 344, 8)[0] == 11
    rows, bpc, vec, staged = kb.rank2_geometry(32, 128, 32, 344, 2, True,
                                               True)
    assert (rows, vec, staged) == (32, 1, 1) and bpc * 344 % 8 == 0
    assert kb._chunk_sizes(32, 30, 8) == [32, 28, 24, 20, 16, 12, 8, 4]
    assert kb._chunk_sizes(3, 30, 8) == [3, 2, 1]      # d = 90: no 16 bytes
    assert kb.rank2_geometry(2, 5, 1, 27648, 4, True, True)[2:] == (0, 0)
    assert kb.rank2_geometry(2, 5, 1, 60000, 4, True, True) is None


def test_launchers_refuse_blocks_too_wide_for_shared_memory():
    x = torch.zeros(1, 1, 60000)
    u = torch.zeros(1, 1, 60000)
    with pytest.raises(ValueError, match="shared memory"):
        kb._geometry(x, u, True)


# ---------------------------------------------------------------------------
# chip_smoke.py's trace patterns for rows 7 and 25
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_R2T = "r2t::(anonymous namespace)::"


@pytest.mark.parametrize("name,op,per_row", [
    (f"void {_R2T}rank2_tile_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
     f"float const*, float const*, __nv_bfloat16*, {_R2T}Geometry, "
     "reflect::Tenants)", "etherplus_reflect_batched", False),
    (f"void {_R2T}rank2_tile_kernel<float>(float const*, float const*, "
     f"float const*, float*, {_R2T}Geometry, reflect::Tenants)",
     "etherplus_reflect_batched", False),
    (f"void {_R2T}rank2_tile_bwd_kernel<__nv_bfloat16>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*, float const*, float const*, "
     f"__nv_bfloat16*, float*, {_R2T}Geometry, reflect::Tenants)",
     "etherplus_reflect_batched_bwd", False),
    (f"{_R2T}bank_ghat_kernel(float const*, float const*, float const*, "
     "float*, float*, float*, int, int, int, int, reflect::Tenants)",
     "etherplus_reflect_batched_bwd", False),
    ("void reflect::rank2_rows_kernel<float, __nv_bfloat16>(float const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int)", None,
     True),
    ("void reflect::reflect_bwd_kernel<__nv_bfloat16, float, false, "
     "true>(__nv_bfloat16 const*, float const*, float const*, float const*, "
     "__nv_bfloat16*, float*, float*, int, int, int, int, int, int, "
     "reflect::Tenants)", None, True),
    ("reflect::bank_chain_kernel(float const*, float const*, float const*, "
     "float*, float*, int, int, int, int, reflect::Tenants)", None, True),
])
def test_the_traces_name_rows_7_and_25(chip_smoke, name, op, per_row):
    """Each tile kernel (by its demangled name) goes to its op alone and
    is no per-row kernel; reflect_common.cuh's per-row kernels go to no
    op of rows 7 and 25 and are what an ETHER+ bank trace must not show."""
    hits = [o for o, pats in chip_smoke.RANK2_KERNELS.items()
            if any(all(k in name for k in keys) for keys in pats)]
    assert hits == ([] if op is None else [op])
    assert any(k in name for k in chip_smoke.PER_ROW_KERNELS) == per_row
