"""The flash kernel's three routes on the card: ``wgmma`` (bf16 prefill on
TMA and wgmma), ``decode`` (a KV group's query rows a block, T split over
blocks) and ``simt`` (float32 prefill, D = 32).

Each route against the plain version ``ref_flash_attention`` within
FLASH_TOL (bf16: relative Frobenius; float32: normalised max error) at
ragged S and T, window edges, rows with no valid key (exact zeros), a
decode cursor at 0, mid-cache and at the end, and a KV head whose
neighbour head is filled with inf (a box that crossed heads would read
it: 0 · inf is NaN); its launch and route counts; two calls bitwise
equal; a decode step encodes no tensor map; an explicit ``cuda`` call at
D = 16 raises.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda_flash.py
"""

import pytest
import torch

from repro_torch.core import execute
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

# bf16: relative Frobenius norm (P rounded to bf16 on the wgmma route,
# one output rounding); float32: normalised max error (the same f32 math,
# sums in another order)
FLASH_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}

# (route, dtype, B, H, Hkv, S, T, D, q_offset, window): ragged S and T,
# window edges inside and across tiles, cached-prefix chunks, rows that
# see no key
CASES = [
    ("wgmma", torch.bfloat16, 2, 4, 2, 200, 200, 128, 0, None),
    ("wgmma", torch.bfloat16, 1, 6, 2, 130, 333, 128, 203, None),
    ("wgmma", torch.bfloat16, 2, 15, 5, 32, 32, 64, 0, None),
    ("wgmma", torch.bfloat16, 1, 4, 1, 300, 300, 64, 0, 100),
    ("wgmma", torch.bfloat16, 1, 4, 2, 257, 257, 128, 0, 128),
    ("wgmma", torch.bfloat16, 1, 4, 2, 256, 128, 64, 136, 16),
    ("wgmma", torch.bfloat16, 1, 4, 2, 96, 500, 128, -40, None),
    ("decode", torch.bfloat16, 2, 40, 8, 1, 2064, 128, 2048, None),
    ("decode", torch.float32, 2, 40, 8, 1, 2064, 128, 1000, None),
    ("decode", torch.bfloat16, 4, 15, 5, 1, 48, 64, 47, None),
    ("decode", torch.float32, 4, 15, 5, 1, 48, 64, 0, None),
    ("decode", torch.float32, 1, 8, 2, 4, 700, 32, 650, 100),
    ("decode", torch.bfloat16, 1, 16, 1, 4, 300, 128, -2, None),
    ("decode", torch.float32, 1, 4, 2, 2, 128, 64, 200, 16),
    ("simt", torch.float32, 2, 4, 2, 200, 200, 128, 0, None),
    ("simt", torch.float32, 1, 4, 1, 300, 300, 64, 0, 100),
    ("simt", torch.bfloat16, 1, 4, 2, 130, 333, 32, 203, None),
]
# decode cursors over one qwen2.5-32b-shaped group cache (T = 2064): the
# first slot, mid-cache (splits past it empty) and the last two slots
CURSORS = (0, 1000, 2062, 2063)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the H100 (see README.md)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, b, h, hkv, s, t, d, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed + s * t + d + h)
    q, k, v = (torch.randn(shape, generator=gen).to(device, dtype)
               for shape in ((b, h, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    return q, k, v


def _err(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return ((got - want).abs().max() / want.abs().max()).item()
    return ((got - want).norm() / want.norm()).item()


def _check(got, want, dtype):
    empty = (want == 0).all(dim=-1)
    assert bool((got[empty] == 0).all()), "a row with no valid key is not 0"
    assert bool(torch.isfinite(got).all())
    if bool((~empty).any()):
        assert _err(got, want, dtype) <= FLASH_TOL[dtype]


def _routed(name):
    return {**dict.fromkeys(ops.routes("flash_attention"), 0),
            f"flash_attention.{name}": 1}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_route_matches_plain_version(cuda_device, case):
    name, dtype, b, h, hkv, s, t, d, off, win = case
    assert fa.route(dtype, d, s * (h // hkv)) == name
    q, k, v = _inputs(cuda_device, dtype, b, h, hkv, s, t, d)
    kw = dict(causal=True, window=win, q_offset=off)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.routes("flash_attention") == _routed(name)
    assert ops.launches()["flash_attention"] == 1
    _check(got, ref.ref_flash_attention(q, k, v, **kw), dtype)
    again = ops.flash_attention(q, k, v, **kw)
    assert torch.equal(got, again), "two calls differ"


@pytest.mark.parametrize("cursor", CURSORS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_cursor(cuda_device, cursor, dtype):
    """One grid at every cursor: the splits come from T alone, and those
    past the cursor contribute nothing."""
    q, k, v = _inputs(cuda_device, dtype, 2, 40, 8, 1, 2064, 128)
    assert fa.decode_splits(2, 8, 2064)[0] > 1
    got = ops.flash_attention(q, k, v, q_offset=cursor)
    _check(got, ref.ref_flash_attention(q, k, v, q_offset=cursor), dtype)
    assert torch.equal(got, ops.flash_attention(q, k, v, q_offset=cursor))


@pytest.mark.parametrize("name,dtype,s,d", [
    ("wgmma", torch.bfloat16, 200, 128), ("wgmma", torch.bfloat16, 130, 64),
    ("decode", torch.bfloat16, 1, 128), ("decode", torch.float32, 3, 64),
    ("simt", torch.float32, 200, 128)])
def test_poisoned_neighbour_head(cuda_device, name, dtype, s, d):
    """KV head 1 filled with inf: KV head 0's query heads must not read
    it at their ragged edge (T = 200 is not a multiple of any tile)."""
    b, h, hkv, t = 1, 8, 2, 200
    q, k, v = _inputs(cuda_device, dtype, b, h, hkv, s, t, d)
    k[:, 1], v[:, 1] = float("inf"), float("inf")
    assert fa.route(dtype, d, s * (h // hkv)) == name
    kw = dict(q_offset=t - s)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)[:, :h // hkv]
    assert ops.routes("flash_attention") == _routed(name)
    want = ref.ref_flash_attention(q[:, :h // hkv], k[:, :1], v[:, :1],
                                   **kw)
    _check(got, want, dtype)


@pytest.mark.parametrize("name,dtype,s,d", [
    ("wgmma", torch.bfloat16, 300, 128), ("wgmma", torch.bfloat16, 300, 64),
    ("simt", torch.float32, 300, 64)])
def test_a_row_is_independent_of_the_rows_beside_it(cuda_device, name,
                                                    dtype, s, d):
    """Batch row 0 alone and beside another row: bitwise equal on the
    prefill routes (the decode route's split count follows B·Hkv)."""
    q, k, v = _inputs(cuda_device, dtype, 2, 4, 2, s, 400, d)
    kw = dict(q_offset=400 - s)
    both = ops.flash_attention(q, k, v, **kw)
    alone = ops.flash_attention(q[:1].contiguous(), k[:1].contiguous(),
                                v[:1].contiguous(), **kw)
    assert fa.route(dtype, d, s * 2) == name
    assert torch.equal(both[:1], alone)


def test_decode_encodes_no_tensor_map(cuda_device):
    q, k, v = _inputs(cuda_device, torch.bfloat16, 2, 40, 8, 1, 2064, 128)
    ops.flash_attention(q, k, v, q_offset=2048)     # builds the library
    before = fa.map_counts()
    for cursor in (2049, 2050):
        ops.flash_attention(q, k, v, q_offset=cursor)
    assert fa.map_counts() == before


def test_prefill_maps_come_from_the_cache(cuda_device):
    q, k, v = _inputs(cuda_device, torch.bfloat16, 1, 4, 2, 256, 256, 128)
    ops.flash_attention(q, k, v)
    before = fa.map_counts()
    ops.flash_attention(q, k, v)
    after = fa.map_counts()
    assert after["lookups"] == before["lookups"] + 3
    assert after["encodes"] == before["encodes"]


def test_explicit_cuda_at_an_unsupported_head_width_raises(cuda_device):
    q, k, v = _inputs(cuda_device, torch.bfloat16, 1, 4, 2, 8, 8, 16)
    with pytest.raises(ops.KernelInputError):
        execute.dispatch("flash_attention", "cuda", q, k, v, causal=True)
    with pytest.raises(ops.KernelInputError):
        ops.flash_attention(q, k, v)
