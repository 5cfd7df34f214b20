"""The rest of the port's method registry held against the JAX package on
the CPU: every ported method's adapters, parameter counts and identity
values; the plain versions of DeLoRA's and HyperAdapt's kernels (forward,
merge and the backward compositions) against the jnp ops,
``repro.kernels.ref`` and the interpret-mode Pallas kernels; serving
(prefill, decode, merged) of OFT, Naive, LoRA, full, DeLoRA and
HyperAdapt, ``train_loss`` with its adapter gradients and a 5-step
AdamW/cosine trajectory against the JAX package on the same weights
(``bridge``); and, port only, the wrappers, the autograd Functions, the
trainer's resume with DeLoRA's 0-d λ leaves and the CLIs.

Every method's init is its identity (DeLoRA's and LoRA's b = 0,
HyperAdapt's r = c = 1, OFT's R = 0, Naive's m = I), where a kernel that
dropped the update or a scale would still agree; every comparison here
perturbs the adapters first, from a seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import flatten_with_paths as jflatten
from repro.configs import get_config as jget_config
from repro.configs import peft_targets as jpeft_targets
from repro.core import methods as jmethods
from repro.core import peft as jpeft
from repro.core import transforms as jT
from repro.core.transforms import PEFTConfig as JPEFTConfig
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.delora_gemm import delora_gemm_pallas
from repro.kernels.hyperadapt_gemm import hyperadapt_gemm_pallas
from repro.kernels.method_merge import (delora_merge_pallas,
                                        hyperadapt_merge_pallas)
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch import NotPortedError, bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute, methods, peft
from repro_torch.core import transforms as T
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, steps, train
from repro_torch.models import api
from repro_torch.optim import adamw, schedules
from repro_torch.runtime.trainer import Trainer

ARCHS = ["smollm-360m", "llama-2-7b"]
METHODS = ["oft", "naive", "lora", "full", "delora", "hyperadapt"]
TRAINED = ["delora", "hyperadapt", "lora", "oft"]
# (T, d, f): one tileable shape, then odd ones (no dim a power of two,
# f = 70 ragged against every tile)
SHAPES = [(128, 256, 128), (5, 96, 70), (7, 120, 96)]
RANKS = [1, 8, 13]
# float32, normalised max error max|a − b| / max|b|: the same sums (up to
# 256 terms in the kernels, four layers in the models) in another order
F32_TOL = 1e-5
# the logits of the four-layer smoke models, prefill and decode against
# the cache: LoRA's b drawn at 0.5 makes ΔW as large as W, and XLA's and
# PyTorch's f32 sums then differ by up to 1.44e-5 (llama2-smoke LoRA, a
# decode step); every other method and step stays under 7e-6
MODEL_TOL = 3e-5
# gradients through four layers, softmax and cross-entropy
GRAD_TOL = 1e-4
# bf16 (8 mantissa bits), relative Frobenius.  The JAX jnp ops cast every
# operand (s, r, c, a, b) to bf16 and round each intermediate; the Pallas
# kernels compute in f32 and round once, as the port does
BF16_TOL = {"jnp": 2e-2, "pallas": 1e-3}
B, P, GEN, S, N_STEPS = 2, 8, 3, 16, 5


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np(t):
    return t.detach().float().numpy()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _delora_inputs(seed, t, d, f, r):
    """x, w, a, b, s (s > 0, as the method's scale is) and a cotangent g."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return (draw(t, d), draw(d, f) / np.float32(np.sqrt(d)), draw(d, r),
            draw(r, f), np.abs(draw(r)) + np.float32(0.1), draw(t, f))


def _hyperadapt_inputs(seed, t, d, f):
    """x, w, r, c (about 1, as trained scales are) and a cotangent g."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return (draw(t, d), draw(d, f) / np.float32(np.sqrt(d)),
            1 + 0.3 * draw(d), 1 + 0.3 * draw(f), draw(t, f))


# ---------------------------------------------------------------------------
# The registry: adapters, counts, identities
# ---------------------------------------------------------------------------

def test_available_is_the_jax_registry_but_vera():
    assert methods.available() == tuple(
        m for m in jmethods.available() if m != "vera")
    with pytest.raises(NotPortedError, match="ROADMAP.md"):
        methods.get("vera")
    # a name neither registry has raises the JAX package's ValueError
    with pytest.raises(methods.UnknownMethodError,
                       match="unknown PEFT method 'no_such_method'"):
        methods.get("no_such_method")
    # bank serving is ported for the bank-servable methods; the others
    # raise the JAX package's error
    with pytest.raises(ValueError, match="is not bank-servable"):
        methods.get("lora").bank_dense(None, None, {}, None)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("d_in,d_out,n_blocks,rank",
                         [(96, 40, 8, 8), (120, 70, 32, 13), (12, 5, 4, 64)])
def test_adapters_param_count_and_identity_match_jax(method, d_in, d_out,
                                                     n_blocks, rank):
    jcfg = JPEFTConfig(method=method, n_blocks=n_blocks, rank=rank,
                       alpha=float(rank))
    tcfg = T.PEFTConfig(method=method, n_blocks=n_blocks, rank=rank,
                        alpha=float(rank))
    jad = jT.init_adapter(jax.random.PRNGKey(0), method, d_in, d_out, jcfg)
    tad = methods.get(method).init(torch.Generator().manual_seed(0), d_in,
                                   d_out, tcfg, (), "cpu")
    assert ({k: tuple(v.shape) for k, v in tad.items()}
            == {k: tuple(np.shape(v)) for k, v in jad.items()})
    assert ({k: v.dtype for k, v in tad.items()}
            == {k: torch.float32 for k in jad})
    assert (T.adapter_param_count(method, d_in, d_out, tcfg)
            == jT.adapter_param_count(method, d_in, d_out, jcfg))
    # the deterministic leaves of the init are JAX's values
    for k, v in jad.items():
        if method != "lora" and not (method == "delora" and k == "a"):
            np.testing.assert_array_equal(_np(tad[k]), np.asarray(v))
    # identity values on a perturbed tree, stacked two deep
    rng = np.random.default_rng(1)
    tree = {"mlp": {k: rng.standard_normal((3, *np.shape(v))).astype(
        np.float32) for k, v in jad.items()}}
    want = _np_tree(jmethods.identity_like(method, tree))
    got = methods.identity_like(method, bridge.to_torch(tree))
    for path, leaf in flatten_with_paths(got):
        np.testing.assert_array_equal(_np(leaf), dict(jflatten(want))[path])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_param_count_matches_jax(arch, method):
    cfg = jget_config(arch, "full")
    shapes = jax.eval_shape(lambda k: japi.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)
    jp, tp = _peft_pair(arch, method)
    assert (peft.adapters_param_count(meta, tp)
            == jpeft.adapters_param_count(shapes, jp))


# ---------------------------------------------------------------------------
# DeLoRA and HyperAdapt: the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("t,d,f", SHAPES)
def test_delora_gemm_and_merge_match_jax(t, d, f, r):
    x, w, a, b, s, _ = _delora_inputs(0, t, d, f, r)
    port = _np(ref.ref_delora_gemm(*map(_t, (x, w, a, b, s))))
    args = tuple(map(_j, (x, w, a, b, s)))
    assert _max_err(port, jT.delora_gemm(*args)) < F32_TOL
    assert _max_err(port, jref.ref_delora_gemm(*args)) < F32_TOL
    assert _max_err(port, delora_gemm_pallas(
        *args, block_m=t, block_f=f, block_k=d, interpret=True)) < F32_TOL
    assert _max_err(_np(T.delora_gemm(*map(_t, (x, w, a, b, s)))),
                    jT.delora_gemm(*args)) < F32_TOL
    port = _np(ref.ref_delora_merge(*map(_t, (w, a, b, s))))
    assert _max_err(port, jT.delora_merge(*args[1:])) < F32_TOL
    assert _max_err(port, delora_merge_pallas(*args[1:], interpret=True)
                    ) < F32_TOL
    assert _max_err(_np(T.delora_merge(*map(_t, (w, a, b, s)))),
                    jT.delora_merge(*args[1:])) < F32_TOL


@pytest.mark.parametrize("t,d,f", SHAPES)
def test_hyperadapt_gemm_and_merge_match_jax(t, d, f):
    x, w, r, c, _ = _hyperadapt_inputs(1, t, d, f)
    port = _np(ref.ref_hyperadapt_gemm(*map(_t, (x, w, r, c))))
    args = tuple(map(_j, (x, w, r, c)))
    assert _max_err(port, jT.hyperadapt_gemm(*args)) < F32_TOL
    assert _max_err(port, hyperadapt_gemm_pallas(
        *args, block_m=t, block_f=f, block_k=d, interpret=True)) < F32_TOL
    assert _max_err(_np(T.hyperadapt_gemm(*map(_t, (x, w, r, c)))),
                    jT.hyperadapt_gemm(*args)) < F32_TOL
    # no column scale: the backward's z and y0
    assert _max_err(_np(ref.ref_hyperadapt_gemm(_t(x), _t(w), _t(r))),
                    (args[0] * args[2]) @ args[1]) < F32_TOL
    port = _np(ref.ref_hyperadapt_merge(*map(_t, (w, r, c))))
    assert _max_err(port, jT.hyperadapt_merge(*args[1:])) < F32_TOL
    assert _max_err(port, hyperadapt_merge_pallas(*args[1:], interpret=True)
                    ) < F32_TOL
    assert _max_err(_np(T.hyperadapt_merge(*map(_t, (w, r, c)))),
                    jT.hyperadapt_merge(*args[1:])) < F32_TOL


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("t,d,f", SHAPES)
def test_delora_backward_matches_jax_ref_and_kernels(t, d, f, r):
    """Against XLA's AD of the jnp op (``ref_delora_gemm_bwd``) and the
    JAX package's own composition (``ops.delora_gemm_bwd``: the forward
    kernel on transposed operands and the zero-hyperplane dw kernel, in
    interpret mode)."""
    x, w, a, b, s, g = _delora_inputs(2, t, d, f, r)
    port = ref.ref_delora_gemm_bwd(*map(_t, (x, w, a, b, s, g)))
    args = tuple(map(_j, (x, w, a, b, s, g)))
    for want in (jref.ref_delora_gemm_bwd(*args),
                 jops.delora_gemm_bwd(*args, interpret=True)):
        for name, p, j in zip(("dx", "dw", "da", "db", "ds"), port, want):
            assert _max_err(_np(p), j) < F32_TOL, name
    port = ref.ref_delora_merge_bwd(*map(_t, (w, a, b, s, x.T @ g)))
    want = jops.delora_merge_bwd(*args[1:5], _j(x.T @ g))
    for name, p, j in zip(("dw", "da", "db", "ds"), port, want):
        assert _max_err(_np(p), j) < F32_TOL, name


@pytest.mark.parametrize("t,d,f", SHAPES)
def test_hyperadapt_backward_matches_jax_ref_and_kernels(t, d, f):
    x, w, r, c, g = _hyperadapt_inputs(3, t, d, f)
    port = ref.ref_hyperadapt_gemm_bwd(*map(_t, (x, w, r, c, g)))
    args = tuple(map(_j, (x, w, r, c, g)))
    for want in (jref.ref_hyperadapt_gemm_bwd(*args),
                 jops.hyperadapt_gemm_bwd(*args, interpret=True)):
        for name, p, j in zip(("dx", "dw", "dr", "dc"), port, want):
            assert _max_err(_np(p), j) < F32_TOL, name
    gw = np.random.default_rng(4).standard_normal((d, f)).astype(np.float32)
    port = ref.ref_hyperadapt_merge_bwd(*map(_t, (w, r, c, gw)))
    for want in (jref.ref_hyperadapt_merge_bwd(*args[1:4], _j(gw)),
                 jops.hyperadapt_merge_bwd(*args[1:4], _j(gw),
                                           interpret=True)):
        for name, p, j in zip(("dw", "dr", "dc"), port, want):
            assert _max_err(_np(p), j) < F32_TOL, name


@pytest.mark.parametrize("op", ["delora_gemm", "delora_merge",
                                "delora_gemm_bwd", "hyperadapt_gemm",
                                "hyperadapt_merge", "hyperadapt_gemm_bwd"])
def test_bf16_plain_versions_match_jax(op):
    """bf16 activations and weights, f32 adapters; DeLoRA's s in the
    activation dtype, as the method layer hands it over."""
    bf, jbf = torch.bfloat16, jnp.bfloat16
    if op.startswith("delora"):
        x, w, a, b, s, g = _delora_inputs(5, 128, 256, 128, 8)
        tx, tw, tg, ts = (_t(v, bf) for v in (x, w, g, s))
        jx, jw, jg, js = (_j(v, jbf) for v in (x, w, g, s))
        ad_t, ad_j = (_t(a), _t(b)), (_j(a), _j(b))
        port = {"delora_gemm": lambda: ref.ref_delora_gemm(tx, tw, *ad_t, ts),
                "delora_merge": lambda: ref.ref_delora_merge(tw, *ad_t, ts),
                "delora_gemm_bwd": lambda: ref.ref_delora_gemm_bwd(
                    tx, tw, *ad_t, ts, tg)[0]}[op]()
        jnp_op = {"delora_gemm": lambda: jT.delora_gemm(jx, jw, *ad_j, js),
                  "delora_merge": lambda: jT.delora_merge(jw, *ad_j, js),
                  "delora_gemm_bwd": lambda: jref.ref_delora_gemm_bwd(
                      jx, jw, *ad_j, js, jg)[0]}[op]()
        kern = {"delora_gemm": lambda: delora_gemm_pallas(
                    jx, jw, *ad_j, js, interpret=True),
                "delora_merge": lambda: delora_merge_pallas(
                    jw, *ad_j, js, interpret=True),
                "delora_gemm_bwd": lambda: jops.delora_gemm_bwd(
                    jx, jw, *ad_j, js, jg, interpret=True)[0]}[op]()
    else:
        x, w, r, c, g = _hyperadapt_inputs(6, 128, 256, 128)
        tx, tw, tg = (_t(v, bf) for v in (x, w, g))
        jx, jw, jg = (_j(v, jbf) for v in (x, w, g))
        sc_t, sc_j = (_t(r), _t(c)), (_j(r), _j(c))
        port = {"hyperadapt_gemm": lambda: ref.ref_hyperadapt_gemm(
                    tx, tw, *sc_t),
                "hyperadapt_merge": lambda: ref.ref_hyperadapt_merge(
                    tw, *sc_t),
                "hyperadapt_gemm_bwd": lambda: ref.ref_hyperadapt_gemm_bwd(
                    tx, tw, *sc_t, tg)[0]}[op]()
        jnp_op = {"hyperadapt_gemm": lambda: jT.hyperadapt_gemm(
                      jx, jw, *sc_j),
                  "hyperadapt_merge": lambda: jT.hyperadapt_merge(jw, *sc_j),
                  "hyperadapt_gemm_bwd": lambda: jref.ref_hyperadapt_gemm_bwd(
                      jx, jw, *sc_j, jg)[0]}[op]()
        kern = {"hyperadapt_gemm": lambda: hyperadapt_gemm_pallas(
                    jx, jw, *sc_j, interpret=True),
                "hyperadapt_merge": lambda: hyperadapt_merge_pallas(
                    jw, *sc_j, interpret=True),
                "hyperadapt_gemm_bwd": lambda: jops.hyperadapt_gemm_bwd(
                    jx, jw, *sc_j, jg, interpret=True)[0]}[op]()
    assert port.dtype == bf
    assert _frob(_np(port), jnp_op) < BF16_TOL["jnp"]
    assert _frob(_np(port), kern) < BF16_TOL["pallas"]


# ---------------------------------------------------------------------------
# Wrappers, dispatch and the autograd Functions (port only)
# ---------------------------------------------------------------------------

def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    x, w, a, b, s, g = map(_t, _delora_inputs(7, 6, 96, 40, 13))
    _, _, r, c, _ = map(_t, _hyperadapt_inputs(7, 6, 96, 40))
    ops.reset_launches()
    same = functools.partial(torch.testing.assert_close, rtol=0, atol=0)
    same(ops.delora_gemm(x.reshape(2, 3, 96), w, a, b, s).reshape(6, 40),
         ref.ref_delora_gemm(x, w, a, b, s))
    same(ops.hyperadapt_gemm(x.reshape(2, 3, 96), w, r, c).reshape(6, 40),
         ref.ref_hyperadapt_gemm(x, w, r, c))
    same(ops.delora_merge(w, a, b, s), ref.ref_delora_merge(w, a, b, s))
    same(ops.hyperadapt_merge(w, r, c), ref.ref_hyperadapt_merge(w, r, c))
    got = ops.delora_gemm_bwd(x.reshape(2, 3, 96), w, a, b, s,
                              g.reshape(2, 3, 40), need_dw=False)
    want = ref.ref_delora_gemm_bwd(x, w, a, b, s, g, need_dw=False)
    assert got[0].shape == (2, 3, 96) and got[1] is None is want[1]
    for p, q in zip(got[2:], want[2:]):
        same(p, q)
    got = ops.hyperadapt_gemm_bwd(x, w, r, c, g, need_dw=True)
    for p, q in zip(got, ref.ref_hyperadapt_gemm_bwd(x, w, r, c, g)):
        same(p, q)
    for p, q in zip(ops.hyperadapt_merge_bwd(w, r, c, w),
                    ref.ref_hyperadapt_merge_bwd(w, r, c, w)):
        same(p, q)
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)
    assert {"delora_gemm", "hyperadapt_gemm", "delora_merge",
            "hyperadapt_merge"} <= set(ops.launches())


@pytest.mark.parametrize("case", ["a_shape", "b_float64", "s_dtype",
                                  "rank", "r_shape", "c_bf16", "g_shape",
                                  "float16"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    x, w, a, b, s, g = map(_t, _delora_inputs(8, 4, 96, 40, 8))
    _, _, r, c, _ = map(_t, _hyperadapt_inputs(8, 4, 96, 40))
    why = {"a_shape": "a must be float32 of shape", "b_float64": "b must be",
           "s_dtype": "s must be bfloat16", "rank": "r ≤ 512",
           "r_shape": "r must be", "c_bf16": "c must be float32",
           "g_shape": "g must be", "float16": "float32 or bfloat16"}[case]
    if case == "a_shape":
        a = a[:-1].contiguous()
    elif case == "b_float64":
        b = b.double()
    elif case == "s_dtype":
        x, w, g = x.to(torch.bfloat16), w.to(torch.bfloat16), g.to(
            torch.bfloat16)
    elif case == "rank":
        a, b, s = torch.randn(96, 513), torch.randn(513, 40), torch.rand(513)
    elif case == "r_shape":
        r = r[:-1]
    elif case == "c_bf16":
        c = c.to(torch.bfloat16)
    elif case == "g_shape":
        g = g[:, :-1].contiguous()
    else:
        x, w, g = x.half(), w.half(), g.half()
    delora = case in ("a_shape", "b_float64", "s_dtype", "rank", "g_shape",
                      "float16")
    if delora:
        with pytest.raises(ops.KernelInputError,
                           match=r"delora_gemm_bwd refuses .*" + why):
            ops.delora_gemm_bwd(x, w, a, b, s, g, need_dw=False)
        if case != "g_shape":
            with pytest.raises(ops.KernelInputError,
                               match=r"delora_gemm refuses x \(.*" + why):
                ops.delora_gemm(x, w, a, b, s)
    if not delora or case in ("g_shape", "float16"):
        with pytest.raises(ops.KernelInputError,
                           match=r"hyperadapt_gemm_bwd refuses .*" + why):
            ops.hyperadapt_gemm_bwd(x, w, r, c, g, need_dw=False)
        if case != "g_shape":
            with pytest.raises(ops.KernelInputError,
                               match=r"hyperadapt_gemm refuses .*" + why):
                ops.hyperadapt_gemm(x, w, r, c)
    if case in ("r_shape", "c_bf16"):
        with pytest.raises(ops.KernelInputError,
                           match=r"hyperadapt_merge refuses .*" + why):
            ops.hyperadapt_merge(w, r, c)
    if case in ("a_shape", "b_float64"):
        with pytest.raises(ops.KernelInputError,
                           match=r"delora_merge refuses .*" + why):
            ops.delora_merge(w, a, b, s)


def test_cuda_backend_on_cpu_raises_without_running_the_plain_version(
        monkeypatch):
    x, w, a, b, s, _ = map(_t, _delora_inputs(9, 4, 96, 40, 8))
    _, _, r, c, _ = map(_t, _hyperadapt_inputs(9, 4, 96, 40))
    ran = []
    ops_args = {"delora_gemm": (x, w, a, b, s), "delora_merge": (w, a, b, s),
                "hyperadapt_gemm": (x, w, r, c),
                "hyperadapt_merge": (w, r, c)}
    for op in ops_args:
        monkeypatch.setitem(execute._REGISTRY, (op, "torch"),
                            lambda *a, op=op: ran.append(op))
    execute.reset_counters()
    for op, args in ops_args.items():
        with pytest.raises(execute.BackendError, match="only on CUDA"):
            execute.dispatch(op, "cuda", *args)
    for method, adapter in (("delora", {"a": a, "b": b,
                                        "lam": torch.tensor(8.0)}),
                            ("hyperadapt", {"r": r, "c": c})):
        cfg = T.PEFTConfig(method=method, backend="cuda")
        with pytest.raises(execute.BackendError):
            T.adapted_dense(x, w, None, adapter, cfg)
    assert ran == [] and execute.counters() == {}


@pytest.mark.parametrize("w_trains", [False, True])
@pytest.mark.parametrize("method", ["delora", "hyperadapt"])
def test_autograd_function_matches_vjp_of_the_plain_forward(method,
                                                            w_trains):
    if method == "delora":
        *prim, g = _delora_inputs(10, 6, 96, 40, 13)
        fn, plain = execute.DeloraGemm, ref.ref_delora_gemm
    else:
        *prim, g = _hyperadapt_inputs(10, 6, 96, 40)
        fn, plain = execute.HyperAdaptGemm, ref.ref_hyperadapt_gemm
    prim = [_t(p) for p in prim]
    prim[0] = prim[0].reshape(2, 3, 96)
    g3 = _t(g).reshape(2, 3, 40)
    leaves = [p.clone().requires_grad_(i != 1 or w_trains)
              for i, p in enumerate(prim)]
    execute.reset_counters()
    fn.apply(*leaves, "auto").backward(g3)
    _, vjp = torch.func.vjp(plain, *prim)
    for i, (leaf, want) in enumerate(zip(leaves, vjp(g3))):
        if i == 1 and not w_trains:
            assert leaf.grad is None
            continue
        assert _max_err(_np(leaf.grad), _np(want)) < F32_TOL, i
    assert execute.counters() == {f"{method}_gemm.torch": 1,
                                  f"{method}_gemm_bwd.torch": 1}


def test_method_semantics_identity_at_init_and_no_grad_serving():
    x, w = torch.randn(4, 96), torch.randn(96, 40)
    for name in ("oft", "naive", "lora", "full", "delora", "hyperadapt"):
        m = methods.get(name)
        cfg = T.PEFTConfig(method=name, n_blocks=8)
        ad = m.init(torch.Generator().manual_seed(0), 96, 40, cfg, (), "cpu")
        torch.testing.assert_close(T.adapted_dense(x, w, None, ad, cfg),
                                   x @ w, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(T.merge_weight(w, ad, cfg), w, rtol=1e-5,
                                   atol=1e-5)
    # DeLoRA's λ is a 0-d leaf per linear, (L,) stacked; s starts at
    # λ/(r·ε) with b = 0
    m = methods.get("delora")
    cfg = T.PEFTConfig(method="delora", rank=4, alpha=2.0)
    st = m.init(torch.Generator().manual_seed(0), 96, 40, cfg, (3,), "cpu")
    assert {k: tuple(v.shape) for k, v in st.items()} == {
        "a": (3, 96, 4), "b": (3, 4, 40), "lam": (3,)}
    torch.testing.assert_close(m.scale(st["a"], st["b"], st["lam"]),
                               torch.full((3, 4), 2.0 / 4 / 1e-8))
    # serving pays nothing for autograd, even with grad-requiring leaves
    ad = {"a": torch.randn(96, 4, requires_grad=True),
          "b": torch.randn(4, 40, requires_grad=True),
          "lam": torch.tensor(2.0, requires_grad=True)}
    execute.reset_counters()
    with torch.no_grad():
        assert m.dense(x, w, ad, cfg).grad_fn is None
    assert execute.counters() == {"delora_gemm.torch": 1}


def test_full_finetuning_trains_the_base_params_only():
    cfg = get_config("smollm-360m", "smoke")
    tp = T.PEFTConfig(method="full", targets=peft_targets("smollm-360m"))
    opt = adamw(schedules.constant(1e-3))
    state = steps.init_state(cfg, tp, opt, device="cpu")
    assert state["adapters"] == {}
    base, adapt = peft.trainable_mask(state["params"], state["adapters"], tp)
    assert all(v for _, v in flatten_with_paths(base)) and adapt == {}
    before = {p: v.clone() for p, v in flatten_with_paths(state["params"])}
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLMStream(
        vocab=cfg.vocab, batch=B, seq_len=S, seed=0).batch_at(0).items()}
    execute.reset_counters()
    new, metrics = steps.make_train_step(cfg, tp, opt)(state, batch)
    # plain products and the attention's plain route, under autograd
    assert execute.counters() == {"flash_attention.torch": cfg.n_layers}
    assert np.isfinite(float(metrics["loss"]))
    moved = [p for p, v in flatten_with_paths(new["params"])
             if not torch.equal(v, before[p])]
    assert len(moved) == len(before)
    assert int(new["step"]) == 1


# ---------------------------------------------------------------------------
# Models and training against JAX, on bridged weights, adapters perturbed
# ---------------------------------------------------------------------------

def _peft_pair(arch, method, rank=8):
    return (JPEFTConfig(method=method, n_blocks=8, rank=rank,
                        alpha=float(rank), targets=jpeft_targets(arch),
                        backend="jnp"),
            T.PEFTConfig(method=method, n_blocks=8, rank=rank,
                         alpha=float(rank), targets=peft_targets(arch)))


def _perturb(adapters, method, seed):
    """Move every method off its identity init: DeLoRA's and LoRA's b and
    DeLoRA's λ, HyperAdapt's r and c around 1, OFT's R, Naive's m."""
    rng = np.random.default_rng(seed)
    spread = {("delora", "b"): 0.5, ("delora", "lam"): 2.0,
              ("lora", "b"): 0.5, ("hyperadapt", "r"): 0.2,
              ("hyperadapt", "c"): 0.2, ("oft", "r"): 0.1,
              ("naive", "m"): 0.1}

    def move(path, leaf):
        sd = spread.get((method, path[-1].key))
        if sd is None:
            return leaf
        return leaf + sd * jnp.asarray(rng.standard_normal(leaf.shape),
                                       leaf.dtype)
    return jax.tree_util.tree_map_with_path(move, adapters)


@functools.lru_cache(maxsize=None)
def _serve_run(arch, method):
    """JAX and port prefill/decode on one smoke model; cached."""
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch, method)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = _perturb(jpeft.init_adapters(jax.random.PRNGKey(1), params,
                                            jp), method, 0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, P)).astype(
        np.int32)
    jcache, jlog = japi.prefill(params, adapters,
                                {"tokens": jnp.asarray(tokens)}, cfg, jp)
    c = japi.pad_cache(jcache, cfg, P + GEN + 1)
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    jtoks, jsteps = [np.asarray(tok)], []
    for _ in range(GEN):
        lg, c = japi.decode_step(params, adapters, c, tok, cfg, jp)
        jsteps.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        jtoks.append(np.asarray(tok))

    tparams = bridge.to_torch(_np_tree(params))
    tadapters = bridge.to_torch(_np_tree(adapters))
    ttok = torch.from_numpy(tokens).long()
    execute.reset_counters()
    tcache, tlog = api.prefill(tparams, tadapters, {"tokens": ttok}, tcfg, tp)
    calls = execute.counters()
    c = api.pad_cache(tcache, tcfg, P + GEN + 1)
    tsteps = []
    for i in range(GEN):                # decode on JAX's greedy tokens
        lg, c = api.decode_step(tparams, tadapters, c,
                                torch.from_numpy(np.array(jtoks[i])).long(),
                                tcfg, tp)
        tsteps.append(lg.numpy())
    execute.reset_counters()
    merged = peft.merge_params(tparams, tadapters, tp)
    merge_calls = execute.counters()
    _, mlog = api.prefill(merged, None, {"tokens": ttok}, tcfg, None)
    _, plain_log = api.prefill(tparams, None, {"tokens": ttok}, tcfg, None)
    return dict(cfg=tcfg, jlog=jlog, jsteps=jsteps, tlog=tlog, tsteps=tsteps,
                mlog=mlog, plain_log=plain_log, calls=calls,
                merge_calls=merge_calls)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_merged_logits_match_jax(arch, method):
    r = _serve_run(arch, method)
    per_pass = 7 * r["cfg"].n_layers
    kernel_op = method in ("delora", "hyperadapt")
    assert r["calls"] == {**({f"{method}_gemm.torch": per_pass}
                             if kernel_op else {}),
                          "flash_attention.torch": r["cfg"].n_layers}
    assert r["merge_calls"] == ({f"{method}_merge.torch": per_pass}
                                if kernel_op else {})
    assert _max_err(r["tlog"], r["jlog"]) < MODEL_TOL
    for t_lg, j_lg in zip(r["tsteps"], r["jsteps"]):
        assert _max_err(t_lg, j_lg) < MODEL_TOL
    assert _max_err(r["mlog"], r["tlog"]) < MODEL_TOL
    # the perturbed adapters moved the logits off the plain model's
    if method == "full":
        assert _max_err(r["tlog"], r["plain_log"]) == 0
    else:
        assert _max_err(r["tlog"], r["plain_log"]) > 1e-3


def _jax_grads(params, adapters, batch, cfg, jp):
    return jax.jit(jax.value_and_grad(
        lambda a, b: japi.train_loss(params, a, b, cfg, jp), has_aux=True))(
        adapters, {k: jnp.asarray(v) for k, v in batch.items()})


def _port_grads(params, adapters, batch, tcfg, tp):
    tadapters = bridge.to_torch(_np_tree(adapters))
    leaves = flatten_with_paths(tadapters)
    for _, leaf in leaves:
        leaf.requires_grad_()
    tloss, _ = api.train_loss(
        bridge.to_torch(_np_tree(params)), tadapters,
        {k: torch.from_numpy(v).long() for k, v in batch.items()}, tcfg, tp)
    tloss.backward()
    return tloss, leaves


@pytest.mark.parametrize("method", TRAINED)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_adapter_grads_match_jax(arch, method):
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch, method)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = _perturb(jpeft.init_adapters(jax.random.PRNGKey(1), params,
                                            jp), method, 1)
    batch = JStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=3).batch_at(0)
    (jloss, _), jgrads = _jax_grads(params, adapters, batch, cfg, jp)
    execute.reset_counters()
    tloss, leaves = _port_grads(params, adapters, batch, tcfg, tp)
    assert abs(tloss.item() - float(jloss)) / float(jloss) < F32_TOL
    jg = dict(jflatten(jgrads))
    assert {p for p, _ in leaves} == set(jg)
    for path, leaf in leaves:
        assert _max_err(_np(leaf.grad), jg[path]) < GRAD_TOL, path
    per_pass = 7 * tcfg.n_layers
    # and each layer's attention, on its plain route under autograd
    assert execute.counters() == {
        **({f"{method}_gemm.torch": per_pass, f"{method}_gemm_bwd.torch":
            per_pass} if method in ("delora", "hyperadapt") else {}),
        "flash_attention.torch": tcfg.n_layers}


def test_delora_gradient_at_its_init_is_nan_in_jax_and_finite_here():
    """The reference's fault (ROADMAP.md, Queue 3): at DeLoRA's init b = 0
    ``jnp.linalg.norm`` differentiates ‖b_j‖ to NaN, so every b leaf's
    gradient is NaN; ``torch.linalg.norm`` takes the zero subgradient,
    and the port's gradients are finite.  Once b ≠ 0 the two agree (the
    test above)."""
    arch = "smollm-360m"
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch, "delora")
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = jpeft.init_adapters(jax.random.PRNGKey(1), params, jp)
    batch = JStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=3).batch_at(0)
    (jloss, _), jgrads = _jax_grads(params, adapters, batch, cfg, jp)
    tloss, leaves = _port_grads(params, adapters, batch, tcfg, tp)
    assert abs(tloss.item() - float(jloss)) / float(jloss) < F32_TOL
    for path, g in jflatten(jgrads):
        kind = path.rsplit("/", 1)[1]
        assert np.isnan(np.asarray(g)).all() == (kind == "b"), path
    for path, leaf in leaves:
        assert torch.isfinite(leaf.grad).all(), path
        if path.endswith("/b"):
            assert leaf.grad.abs().max() > 0, path


@functools.lru_cache(maxsize=None)
def _trajectories(method):
    """5 AdamW/cosine steps of both packages from one JAX state."""
    arch = "smollm-360m"
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch, method)
    jopt = jadamw(jsched.cosine(2e-3, N_STEPS, 2))
    topt = adamw(schedules.cosine(2e-3, N_STEPS, 2))
    jstate = jsteps.init_state(jax.random.PRNGKey(0), cfg, jp, jopt)
    jstate = dict(jstate, adapters=_perturb(jstate["adapters"], method, 2))
    jstate["opt_state"] = jopt.init(jstate["adapters"])
    init = _np_tree(jstate["adapters"])
    bridged = bridge.to_torch(_np_tree(jstate))
    tstate = dict(steps.make_state(bridged["params"], bridged["adapters"],
                                   tp, topt),
                  opt_state=bridged["opt_state"], step=bridged["step"])
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=0)
    jstep = jax.jit(jsteps.make_train_step(cfg, jp, jopt))
    tstep = steps.make_train_step(tcfg, tp, topt)
    jl, tl = [], []
    for i in range(N_STEPS):
        b = stream.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v).long()
                                    for k, v in b.items()})
        jl.append([float(jm["loss"]), float(jm["grad_norm"])])
        tl.append([float(tm["loss"]), float(tm["grad_norm"])])
    return dict(jstate=jstate, tstate=tstate, jl=np.array(jl),
                tl=np.array(tl), init=init)


@pytest.mark.parametrize("method", TRAINED)
def test_adamw_cosine_trajectory_matches_jax(method):
    r = _trajectories(method)
    assert np.isfinite(r["tl"]).all()
    assert np.abs(r["tl"] - r["jl"]).max() / np.abs(r["jl"]).max() < GRAD_TOL
    jfin = dict(jflatten(_np_tree(r["jstate"]["adapters"])))
    init = dict(jflatten(r["init"]))
    for path, leaf in flatten_with_paths(r["tstate"]["adapters"]):
        assert _max_err(_np(leaf) - init[path],
                        jfin[path] - init[path]) < GRAD_TOL, path
    assert int(r["tstate"]["step"]) == N_STEPS


# ---------------------------------------------------------------------------
# Checkpoints, the trainer and the CLIs (port only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["delora", "oft", "hyperadapt"])
def test_checkpoint_round_trip_of_the_new_leaves_is_bitwise(tmp_path,
                                                            method):
    """DeLoRA's 0-d (stacked (L,)) float λ and OFT's (L, n, db, db) R
    blocks save and restore bitwise, optimizer state included."""
    cfg = get_config("smollm-360m", "smoke")
    _, tp = _peft_pair("smollm-360m", method)
    state = steps.init_state(cfg, tp, adamw(schedules.constant(1e-3)),
                             device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, extra={"data": {"step": 3}}, block=True)
    template = steps.init_state(cfg, tp, adamw(schedules.constant(1e-3)),
                                seed=1, device="cpu")
    restored, extra = mgr.restore(template=template)
    mgr.close()
    assert extra["data"] == {"step": 3}
    want = dict(flatten_with_paths(state))
    got = flatten_with_paths(restored)
    assert len(got) == len(want)
    for path, leaf in got:
        assert leaf.dtype == want[path].dtype and torch.equal(
            leaf, want[path]), path


def test_trainer_resume_from_delora_init_ends_bitwise_equal(tmp_path):
    """DeLoRA from its own init (b = 0): finite losses, and a run that
    crashes and resumes from its checkpoint ends bitwise equal."""
    cfg = get_config("smollm-360m", "smoke")
    _, tp = _peft_pair("smollm-360m", "delora")
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=0)

    def trainer(name, **kw):
        return Trainer(cfg, tp, adamw(schedules.cosine(2e-3, 4, 1)),
                       ckpt_dir=str(tmp_path / name), ckpt_every=2, seed=0,
                       device="cpu", **kw)
    ref_run = trainer("ref")
    metrics = ref_run.fit(stream, steps=4)
    ref_run.close()
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    crashed = trainer("run", fail_at_step=3)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        crashed.fit(stream, steps=4)
    crashed.close()
    resumed = trainer("run")
    assert resumed.step == 2
    resumed.fit(stream, steps=4)
    resumed.close()
    for key in ("adapters", "opt_state", "step"):
        want = dict(flatten_with_paths(ref_run.state[key]))
        for path, leaf in flatten_with_paths(resumed.state[key]):
            assert torch.equal(leaf, want[path]), f"{key}/{path}"
    b = ref_run.state["adapters"]["units"]["pos0"]["mlp"]["down_proj"]["b"]
    assert b.abs().max() > 0          # b moved off its init


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("method", ["delora", "hyperadapt", "lora"])
def test_serve_cli_runs_the_new_methods_on_cpu(method, merged, capsys):
    res = serve.main(["--device", "cpu", "--method", method, "--gen", "2",
                      "--batch", "2", "--prompt-len", "8", "--rank", "4"]
                     + (["--merged"] if merged else []))
    out = capsys.readouterr().out
    assert res["tokens"].shape == (2, 3) and torch.isfinite(
        res["logits"]).all()
    per_forward = 7 * 4
    want = ({} if method == "lora" else
            {f"{method}_merge.torch": per_forward} if merged else
            {f"{method}_gemm.torch": per_forward * res["forwards"]})
    want["flash_attention.torch"] = 4 * res["forwards"]
    assert f"dispatch counters: {want}" in out


@pytest.mark.parametrize("method", ["delora", "hyperadapt", "lora"])
def test_train_cli_runs_the_new_methods_on_cpu(method, capsys):
    metrics = train.main(["--device", "cpu", "--variant", "smoke",
                          "--method", method, "--steps", "2", "--batch", "2",
                          "--seq-len", "16", "--rank", "4"])
    assert "done @ step 2" in capsys.readouterr().out
    assert np.isfinite(metrics["loss"]) and metrics["step"] == 2


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_clis_refuse_vera(cli):
    with pytest.raises(NotPortedError, match="'vera'"):
        if cli == "serve":
            serve.main(["--device", "cpu", "--method", "vera", "--gen", "1"])
        else:
            train.main(["--device", "cpu", "--method", "vera", "--steps",
                        "1"])


def test_full_finetuning_cli_trains_on_cpu(capsys):
    metrics = train.main(["--device", "cpu", "--variant", "smoke",
                          "--method", "full", "--steps", "2", "--batch", "2",
                          "--seq-len", "16"])
    assert "done @ step 2" in capsys.readouterr().out
    assert np.isfinite(metrics["loss"])
