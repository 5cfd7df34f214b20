"""The port's ETHER kernels: their plain versions held against the JAX
package (``repro.kernels.ref`` and the Pallas kernels in interpret mode)
on the same numpy inputs, and the wrappers' input checks and dispatch.
The CUDA kernels themselves are tested on the card by test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import transforms as jT
from repro.kernels import ref as jref
from repro.kernels.ether_merge import ether_merge_pallas
from repro.kernels.householder_gemm import householder_gemm_pallas
from repro_torch.core import execute
from repro_torch.core import transforms as T
from repro_torch.kernels import ops, ref

# (T, d, f, n): one tileable shape, then odd ones (db = 12 and db = 15)
SHAPES = [(128, 256, 128, 4), (5, 96, 96, 8), (5, 120, 96, 8)]
# float32: the same ≤ 256-term sums taken in another order; normalised
# max error max|a − b| / max|b|
F32_TOL = 1e-5
# bf16 (8 mantissa bits), relative Frobenius: the JAX path rounds û, the
# reflected x and the output to bf16, the port only the output
BF16_TOL = 2e-2


def _inputs(seed, t, d, f, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    u = rng.standard_normal((n, d // n)).astype(np.float32)
    return x, w, u


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_householder_gemm_matches_jax(t, d, f, n):
    x, w, u = _inputs(0, t, d, f, n)
    port = ref.ref_householder_gemm(_t(x), _t(w), _t(u)).numpy()
    assert _max_err(port, jref.ref_householder_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(u))) < F32_TOL
    assert _max_err(port, householder_gemm_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(u),
        interpret=True)) < F32_TOL


@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_ether_merge_matches_jax(t, d, f, n):
    _, w, u = _inputs(1, t, d, f, n)
    port = ref.ref_ether_merge(_t(w), _t(u)).numpy()
    assert _max_err(port, jref.ref_ether_merge(jnp.asarray(w),
                                               jnp.asarray(u))) < F32_TOL
    assert _max_err(port, ether_merge_pallas(jnp.asarray(w), jnp.asarray(u),
                                             interpret=True)) < F32_TOL


@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_transform_primitives_match_jax(t, d, f, n):
    x, w, u = _inputs(2, t, d, f, n)
    assert _max_err(T.reflect_activation(_t(x), _t(u)).numpy(),
                    jT.reflect_activation(jnp.asarray(x),
                                          jnp.asarray(u))) < F32_TOL
    assert _max_err(T.reflect_weight(_t(w), _t(u)).numpy(),
                    jT.reflect_weight(jnp.asarray(w),
                                      jnp.asarray(u))) < F32_TOL
    assert _max_err(T._unit(_t(u)).numpy(),
                    jT._unit(jnp.asarray(u))) < F32_TOL
    assert T.resolve_blocks(n, d) == jT.resolve_blocks(n, d)
    assert T.resolve_blocks(7, 344) == jT.resolve_blocks(7, 344)


@pytest.mark.parametrize("op", ["householder_gemm", "ether_merge"])
def test_bf16_plain_versions_match_jax(op):
    x, w, u = _inputs(3, 5, 96, 96, 8)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    xt, wt = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    if op == "householder_gemm":
        port = ref.ref_householder_gemm(xt, wt, _t(u))
        want = jref.ref_householder_gemm(xb, wb, jnp.asarray(u))
    else:
        port = ref.ref_ether_merge(wt, _t(u))
        want = jref.ref_ether_merge(wb, jnp.asarray(u))
    assert port.dtype == torch.bfloat16
    assert _frob(port.float().numpy(), want) < BF16_TOL


def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    x, w, u = _inputs(4, 6, 96, 64, 8)
    ops.reset_launches()
    x3 = _t(x).reshape(2, 3, 96)
    y = ops.householder_gemm(x3, _t(w), _t(u))
    assert y.shape == (2, 3, 64)
    np.testing.assert_array_equal(
        y.reshape(6, 64).numpy(),
        ref.ref_householder_gemm(_t(x), _t(w), _t(u)).numpy())
    np.testing.assert_array_equal(ops.ether_merge(_t(w), _t(u)).numpy(),
                                  ref.ref_ether_merge(_t(w), _t(u)).numpy())
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)
    assert set(ops.launches()) >= {"householder_gemm", "ether_merge",
                                   "reflect_gemm_dx", "reflect_gemm_dw"}


@pytest.mark.parametrize("case", ["float16", "w_dtype", "u_float64",
                                  "n_db", "strided", "empty"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    x, w, u = (_t(a) for a in _inputs(5, 4, 96, 64, 8))
    if case == "float16":
        x, w = x.half(), w.half()
    elif case == "w_dtype":
        w = w.to(torch.bfloat16)
    elif case == "u_float64":
        u = u.double()
    elif case == "n_db":
        u = u[:, :-1].contiguous()
    elif case == "strided":
        x = x.t().contiguous().t()
    else:
        x = x[:0]
    with pytest.raises(ops.KernelInputError, match=r"householder_gemm "
                       r"refuses x \(.*\) torch\.\w+"):
        ops.householder_gemm(x, w, u)
    if case in ("float16", "u_float64", "n_db"):
        with pytest.raises(ops.KernelInputError, match="ether_merge refuses"):
            ops.ether_merge(w, u)


def test_cuda_backend_on_cpu_raises_without_running_the_plain_version(
        monkeypatch):
    x, w, u = (_t(a) for a in _inputs(6, 4, 96, 64, 8))
    ran = []
    for op in ("householder_gemm", "ether_merge"):
        monkeypatch.setitem(execute._REGISTRY, (op, "torch"),
                            lambda *a, op=op: ran.append(op))
    execute.reset_counters()
    ops.reset_launches()
    with pytest.raises(execute.BackendError, match="only on CUDA tensors"):
        execute.dispatch("householder_gemm", "cuda", x, w, u)
    with pytest.raises(execute.BackendError, match="only on CUDA tensors"):
        execute.dispatch("ether_merge", "cuda", w, u)
    peft = T.PEFTConfig(n_blocks=8, backend="cuda")
    with pytest.raises(execute.BackendError):
        T.adapted_dense(x, w, None, {"u": u}, peft)
    assert ran == []
    assert execute.counters() == {}
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)


def test_auto_backend_takes_the_plain_version_on_cpu():
    x, w, u = (_t(a) for a in _inputs(7, 4, 96, 64, 8))
    execute.reset_counters()
    y = T.adapted_dense(x, w, None, {"u": u}, T.PEFTConfig(n_blocks=8))
    assert execute.counters() == {"householder_gemm.torch": 1}
    np.testing.assert_array_equal(
        y.numpy(), ref.ref_householder_gemm(x, w, u).numpy())
