"""householder_gemm's route rule and the wgmma routes' arithmetic, and
``auto`` attention's rule for the flash kernel, on the CPU.

The wgmma routes compute y = x·W − 2·P·U with the tensor cores' f32 sum
of the stored bf16 x and W, P[t, i] = x_t,i·û_i and U[i, :] = û_iᵀ·W_i
summed on the CUDA cores in 16-row quarters of each 64-row K step, the
quarters added in order, then y rounded once.  ``_emulate`` repeats that
arithmetic here, in this file alone, and the tests hold it against the
JAX package's ``householder_gemm`` (``repro.kernels.ref`` and the Pallas
kernel in interpret mode) on the same seeded numpy inputs, at the block
widths of the main paths: db 120 and 320 (smollm-360m), 640 and 3456
(qwen2.5-32b), n = 8.  The CUDA kernel itself runs on the card
(tests/test_torch_cuda_hh.py)."""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro.kernels.householder_gemm import householder_gemm_pallas
from repro_torch.core import execute
from repro_torch.kernels import householder_gemm as hh
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve

# (t, d, f, n) at the main paths' block widths: db = d / n
WIDTHS = [(5, 960, 64, 8), (20, 2560, 64, 8), (3, 5120, 48, 8),
          (2, 27648, 40, 8)]
# bf16: one rounding of the f32 result on the kernel's side, relative
# Frobenius; float32: the same f32 math in another order of the sums,
# normalised max error
BF16_TOL, F32_TOL = 1e-2, 1e-5
K_STEP, QUARTER = 64, 16


def _inputs(seed, t, d, f, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    u = rng.standard_normal((n, d // n)).astype(np.float32)
    return x, w, u


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _emulate(x, w, u, round_to_bf16=True):
    """The wgmma routes' arithmetic in float32: acc = x·W (the tensor
    cores' sum of exact products), P from the projection prologue, U from
    the W tiles in quarters of each K step, then acc − 2·P·U block by
    block in order, rounded once."""
    x, w, u = (torch.from_numpy(a) for a in (x, w, u))
    t, d = x.shape
    n, db = u.shape
    nrm = u.norm(dim=1) + 1e-8                                 # (n,)
    p = (x.view(t, n, db) * u).sum(-1) / nrm                   # (t, n)
    rows = torch.arange(d)
    quarter = (rows % K_STEP) // QUARTER
    block = rows // db
    uw = u.reshape(d, 1) * w                                   # (d, f)
    parts = torch.zeros(4, n, w.shape[1])
    parts.index_put_((quarter, block), uw, accumulate=True)
    big_u = (((parts[0] + parts[1]) + parts[2]) + parts[3]) / nrm[:, None]
    y = x @ w
    for i in range(n):
        y = y + (-2 * p[:, i:i + 1]) * big_u[i]
    if round_to_bf16:
        y = y.bfloat16().float()
    return y.numpy()


@pytest.mark.parametrize("t,d,f,n", WIDTHS)
def test_emulated_bf16_routes_match_jax(t, d, f, n):
    x, w, u = _inputs(t + d, t, d, f, n)
    xb, wb = _bf16(x), _bf16(w)
    want = jref.ref_householder_gemm(jnp.asarray(xb), jnp.asarray(wb),
                                     jnp.asarray(u))
    assert _frob(_emulate(xb, wb, u), want) < BF16_TOL


@pytest.mark.parametrize("t,d,f,n", WIDTHS)
def test_emulated_routes_keep_f32_round_once_agreement(t, d, f, n):
    """Without the bf16 rounding, the rank-n form agrees with the
    reflected product in f32: the JAX reference and the port's plain
    version."""
    x, w, u = _inputs(t * d, t, d, f, n)
    got = _emulate(x, w, u, round_to_bf16=False)
    assert _max_err(got, jref.ref_householder_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(u))) < F32_TOL
    assert _max_err(got, ref.ref_householder_gemm(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(u)).numpy()) < F32_TOL


def test_emulated_route_matches_interpret_pallas():
    t, d, f, n = 8, 256, 128, 2        # db 128: tileable for the kernel
    x, w, u = _inputs(3, t, d, f, n)
    want = householder_gemm_pallas(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(u), interpret=True)
    assert _max_err(_emulate(x, w, u, round_to_bf16=False),
                    want) < F32_TOL


@pytest.mark.parametrize("dtype,t,d,f,n,aligned,want", [
    (torch.bfloat16, 1, 960, 2560, 8, True, "wgmma_decode"),
    (torch.bfloat16, hh.DECODE_ROWS, 960, 2560, 8, True, "wgmma_decode"),
    (torch.bfloat16, hh.DECODE_ROWS + 1, 960, 2560, 8, True, "wgmma"),
    (torch.bfloat16, 4096, 5120, 27648, 8, True, "wgmma"),
    (torch.bfloat16, 1024, 960, 2560, hh.WGMMA_MAX_BLOCKS, True, "wgmma"),
    (torch.bfloat16, 1024, 960, 2560, 64, True, "simt"),
    (torch.bfloat16, 4, 120, 70, 8, True, "simt"),
    (torch.bfloat16, 4, 100, 64, 4, True, "simt"),
    (torch.bfloat16, 4, 960, 2560, 8, False, "simt"),
    (torch.float32, 4, 960, 2560, 8, True, "simt"),
    (torch.float32, 4096, 5120, 27648, 8, True, "simt"),
])
def test_route_rule(dtype, t, d, f, n, aligned, want):
    assert hh.route(dtype, t, d, f, n, aligned) == want


def test_cpu_calls_count_no_launch_and_no_route():
    x, w, u = (torch.from_numpy(a) for a in _inputs(4, 4, 96, 64, 8))
    ops.reset_launches()
    ops.householder_gemm(x.bfloat16(), w.bfloat16(), u)
    assert set(ops.routes()) == {f"householder_gemm.{r}" for r in hh.ROUTES}
    assert set(ops.routes().values()) == {0}
    assert ops.launches()["householder_gemm"] == 0


def _attn(d, h=4, hkv=2, dtype=torch.float32):
    q = torch.zeros(1, h, 3, d, dtype=dtype)
    k = torch.zeros(1, hkv, 5, d, dtype=dtype)
    return q, k, k


@pytest.mark.parametrize("d,want", [(12, False), (16, False), (64, True),
                                    (128, True)])
def test_flash_attention_rule_takes_the_kernels_head_widths(d, want):
    assert execute.supports("flash_attention", *_attn(d), causal=True) is want


@pytest.mark.parametrize("case", ["half", "heads", "empty", "window"])
def test_flash_attention_rule_refuses_what_the_kernel_refuses(case):
    q, k, v = _attn(64)
    kw = {}
    if case == "half":
        q, k, v = _attn(64, dtype=torch.float16)
    elif case == "heads":
        q, k, v = _attn(64, h=5, hkv=2)
    elif case == "empty":
        q = q[:, :, :0]
    else:
        kw = {"window": 2.5}
    assert not execute.supports("flash_attention", q, k, v, **kw)
    with pytest.raises(ops.KernelInputError):
        ops.flash_attention(q, k, v, **kw)


def test_ops_without_a_rule_take_every_shape():
    x = torch.zeros(3, 5)
    assert execute.supports("householder_gemm", x, x, x)
    assert execute.selected_backend("householder_gemm", "auto", x) == "torch"


def test_serve_cli_counts_the_plain_attention_for_narrow_heads():
    out = io.StringIO()
    execute.reset_counters()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "qwen2.5-32b", "--variant", "smoke",
                    "--backend", "auto", "--device", "cpu", "--gen", "2"])
    text = out.getvalue()
    assert "'flash_attention.torch'" in text
    assert "flash_attention.cuda" not in text
