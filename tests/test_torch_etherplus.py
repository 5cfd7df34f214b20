"""The port's ETHER+ slice held against the JAX package on the CPU: the
plain versions of etherplus_gemm, etherplus_merge, etherplus_reflect_bwd
and the rank-2 reflect-GEMM backward against ``repro.kernels.ref`` and
the interpret-mode Pallas kernels; serving (prefill, decode, merged),
``train_loss`` with its adapter gradients and a 5-step AdamW/cosine
trajectory against the JAX package on the same weights (``bridge``); and,
port only, the wrappers, the method's semantics, the trainer's bitwise
resume with four-leaf adapters and the CLIs.

ETHER+ starts at H⁺ = I (v = u), where a kernel that ignored both
directions would still agree; every comparison here draws v apart from
u."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import flatten_with_paths as jflatten
from repro.configs import get_config as jget_config
from repro.configs import peft_targets as jpeft_targets
from repro.core import peft as jpeft
from repro.core import transforms as jT
from repro.core.transforms import PEFTConfig as JPEFTConfig
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.etherplus_gemm import etherplus_gemm_pallas
from repro.kernels.etherplus_merge import (etherplus_merge_left_pallas,
                                           etherplus_merge_right_pallas)
from repro.kernels.gemm_bwd import (reflect_gemm_dw_pallas,
                                    reflect_gemm_dx_pallas)
from repro.kernels.reflect_bwd import etherplus_reflect_bwd_pallas
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch import bridge
from repro_torch.checkpoint import latest_step
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
# (T, d, f, n): one tileable shape, then odd ones (db = 12 and 15, output
# blocks db_out = 12, and a ragged f = 70 with 7 output blocks of 10)
SHAPES = [(128, 256, 128, 4), (5, 96, 96, 8), (5, 120, 96, 8),
          (7, 120, 70, 8)]
# float32, normalised max error max|a − b| / max|b|: the same sums (up to
# 256 terms in the kernels, four layers in the models) in another order
F32_TOL = 1e-5
# gradients through four layers, softmax and cross-entropy
GRAD_TOL = 1e-4
# bf16 (8 mantissa bits), relative Frobenius.  The JAX jnp reference
# rounds û, v̂, H⁺x and the pre-epilogue y to bf16; the Pallas kernels
# compute in f32 and round once, as the port does
BF16_TOL = {"jnp": 2e-2, "pallas": 1e-3}
B, P, GEN, S, N_STEPS = 2, 8, 4, 16, 5


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, t, d, f, n, two_sided=True):
    """x, w, u1, v1, u2, v2 (None one-sided) and a cotangent g, with v1
    and v2 drawn apart from u1 and u2."""
    rng = np.random.default_rng(seed)
    n_out = T.resolve_blocks(n, f)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x, w = draw(t, d), draw(d, f) / np.float32(np.sqrt(d))
    u1, v1 = draw(n, d // n), draw(n, d // n)
    u2, v2 = draw(n_out, f // n_out), draw(n_out, f // n_out)
    if not two_sided:
        u2 = v2 = None
    return x, w, u1, v1, u2, v2, draw(t, f)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _tt(a, dtype=torch.float32):
    return None if a is None else _t(a).to(dtype)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's references and kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_etherplus_gemm_matches_jax(t, d, f, n, two_sided):
    x, w, u1, v1, u2, v2, _ = _inputs(0, t, d, f, n, two_sided)
    port = ref.ref_etherplus_gemm(*map(_tt, (x, w, u1, v1, u2, v2))).numpy()
    args = tuple(map(_j, (x, w, u1, v1, u2, v2)))
    assert _max_err(port, jref.ref_etherplus_gemm(*args)) < F32_TOL
    # the Pallas kernel in interpret mode, the tiles its wrapper picks
    assert _max_err(port, etherplus_gemm_pallas(
        *args, block_m=t, block_f=f, block_k=d, interpret=True)) < F32_TOL


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_etherplus_merge_matches_jax(t, d, f, n, two_sided):
    _, w, u1, v1, u2, v2, _ = _inputs(1, t, d, f, n, two_sided)
    port = ref.ref_etherplus_merge(*map(_tt, (w, u1, v1, u2, v2))).numpy()
    args = tuple(map(_j, (w, u1, v1, u2, v2)))
    assert _max_err(port, jref.ref_etherplus_merge(*args)) < F32_TOL
    want = etherplus_merge_left_pallas(*args[:3], interpret=True)
    if two_sided:
        want = etherplus_merge_right_pallas(want, *args[3:], interpret=True)
    assert _max_err(port, want) < F32_TOL


@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_etherplus_transform_primitives_match_jax(t, d, f, n):
    x, w, u1, v1, u2, v2, _ = _inputs(2, t, d, f, n)
    assert _max_err(T.etherplus_activation(_t(x), _t(u1), _t(v1)).numpy(),
                    jT.etherplus_activation(*map(_j, (x, u1, v1)))) < F32_TOL
    for side, (a, b) in (("left", (u1, v1)), ("right", (u2, v2))):
        assert _max_err(T.etherplus_weight(_t(w), _t(a), _t(b), side).numpy(),
                        jT.etherplus_weight(*map(_j, (w, a, b)), side=side)
                        ) < F32_TOL
    with pytest.raises(ValueError, match="side"):
        T.etherplus_weight(_t(w), _t(u1), _t(v1), "up")


@pytest.mark.parametrize("op", ["etherplus_gemm", "etherplus_merge"])
def test_bf16_plain_versions_match_jax(op):
    x, w, u1, v1, u2, v2, _ = _inputs(3, 5, 96, 96, 8)
    xb, wb = _j(x, jnp.bfloat16), _j(w, jnp.bfloat16)
    xt, wt = _tt(x, torch.bfloat16), _tt(w, torch.bfloat16)
    ad = tuple(map(_j, (u1, v1, u2, v2)))
    at = tuple(map(_tt, (u1, v1, u2, v2)))
    if op == "etherplus_gemm":
        port = ref.ref_etherplus_gemm(xt, wt, *at)
        want = jref.ref_etherplus_gemm(xb, wb, *ad)
        kern = etherplus_gemm_pallas(xb, wb, *ad, interpret=True)
    else:
        port = ref.ref_etherplus_merge(wt, *at)
        want = jref.ref_etherplus_merge(wb, *ad)
        kern = etherplus_merge_right_pallas(
            etherplus_merge_left_pallas(wb, *ad[:2], interpret=True),
            *ad[2:], interpret=True)
    assert port.dtype == torch.bfloat16
    assert _frob(_np(port), want) < BF16_TOL["jnp"]
    assert _frob(_np(port), kern) < BF16_TOL["pallas"]


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_plain_backward_matches_jax_ref(t, d, f, n, two_sided):
    x, w, u1, v1, u2, v2, g = _inputs(4, t, d, f, n, two_sided)
    port = ref.ref_etherplus_gemm_bwd(*map(_tt, (x, w, u1, v1, u2, v2, g)))
    want = jref.ref_etherplus_gemm_bwd(*map(_j, (x, w, u1, v1, u2, v2, g)))
    names = ("dx", "dw", "du1", "dv1", "du2", "dv2")
    for name, p, j in zip(names, port, want):
        if j is None:
            assert p is None, name
        else:
            assert _max_err(_np(p), j) < F32_TOL, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("two_sided", [True, False])
def test_plain_backward_matches_interpret_pallas_kernels(two_sided, dtype):
    """The JAX package's own composition (``ops.etherplus_gemm_bwd``: the
    one-sided forward kernel for y0, etherplus_reflect_bwd_pallas, then
    the rank-2 reflect_gemm_dx/dw kernels), in interpret mode."""
    x, w, u1, v1, u2, v2, g = _inputs(5, 128, 256, 128, 4, two_sided)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    port = ref.ref_etherplus_gemm_bwd(
        _tt(x, tdt), _tt(w, tdt), *map(_tt, (u1, v1, u2, v2)), _tt(g, tdt))
    want = jops.etherplus_gemm_bwd(
        _j(x, jdt), _j(w, jdt), *map(_j, (u1, v1, u2, v2)), _j(g, jdt),
        interpret=True)
    assert port[0].dtype == port[1].dtype == tdt
    for name, p, j in zip(("dx", "dw", "du1", "dv1", "du2", "dv2"), port,
                          want):
        if j is None:
            assert p is None, name
        elif dtype == "float32":
            assert _max_err(_np(p), j) < F32_TOL, name
        else:
            assert _frob(_np(p), j) < BF16_TOL["pallas"], name


@pytest.mark.parametrize("t,d,n", [(128, 256, 4), (7, 120, 8)])
def test_reflect_bwd_and_rank2_gemm_bwd_match_interpret_pallas(t, d, n):
    x, w, u, v, _, _, g = _inputs(6, t, d, 96, n)
    gx = np.random.default_rng(7).standard_normal((t, d)).astype(np.float32)
    port = ref.ref_etherplus_reflect_bwd(_t(x), _t(u), _t(v), _t(gx))
    want = etherplus_reflect_bwd_pallas(*map(_j, (x, u, v, gx)),
                                        interpret=True)
    for name, p, j in zip(("dx", "du", "dv"), port, want):
        assert _max_err(_np(p), j) < F32_TOL, name
    port = ref.ref_reflect_gemm_dx(_t(x), _t(w), _t(u), _t(g), _t(v))
    want = reflect_gemm_dx_pallas(*map(_j, (x, w, u, g, v)), block_m=t,
                                  block_d=d, block_f=96, interpret=True)
    for name, p, j in zip(("dx", "du", "dv"), port, want):
        assert _max_err(_np(p), j) < F32_TOL, name
    assert _max_err(
        _np(ref.ref_reflect_gemm_dw(_t(x), _t(u), _t(g), torch.float32,
                                    _t(v))),
        reflect_gemm_dw_pallas(*map(_j, (x, u, g, v)), block_m=t, block_d=d,
                               block_f=96, interpret=True)) < F32_TOL


# ---------------------------------------------------------------------------
# Wrappers, dispatch and the autograd Function (port only)
# ---------------------------------------------------------------------------

def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    x, w, u1, v1, u2, v2, g = (None if a is None else _t(a)
                               for a in _inputs(8, 6, 96, 64, 8))
    ops.reset_launches()
    y = ops.etherplus_gemm(x.reshape(2, 3, 96), w, u1, v1, u2, v2)
    assert y.shape == (2, 3, 64)
    torch.testing.assert_close(y.reshape(6, 64), ref.ref_etherplus_gemm(
        x, w, u1, v1, u2, v2), rtol=0, atol=0)
    torch.testing.assert_close(ops.etherplus_merge(w, u1, v1, u2, v2),
                               ref.ref_etherplus_merge(w, u1, v1, u2, v2),
                               rtol=0, atol=0)
    got = ops.etherplus_gemm_bwd(x.reshape(2, 3, 96), w, u1, v1, u2, v2,
                                 g.reshape(2, 3, 64), need_dw=False)
    want = ref.ref_etherplus_gemm_bwd(x, w, u1, v1, u2, v2, g, need_dw=False)
    assert got[0].shape == (2, 3, 96) and got[1] is None is want[1]
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)


@pytest.mark.parametrize("case", ["v_shape", "v_float64", "u2_alone",
                                  "u2_blocks", "g_shape", "float16"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    x, w, u1, v1, u2, v2, g = (None if a is None else _t(a)
                               for a in _inputs(9, 4, 96, 64, 8))
    why = {"v_shape": "v must be", "v_float64": "v must be",
           "u2_alone": "u2 and v2", "u2_blocks": "u2 and v2",
           "g_shape": "g must be", "float16": "float32 or bfloat16"}[case]
    if case == "v_shape":
        v1 = v1[:, :-1].contiguous()
    elif case == "v_float64":
        v1 = v1.double()
    elif case == "u2_alone":
        v2 = None
    elif case == "u2_blocks":
        u2 = v2 = torch.randn(5, 12)
    elif case == "g_shape":
        g = g[:, :-1].contiguous()
    else:
        x, w, g = x.half(), w.half(), g.half()
    with pytest.raises(ops.KernelInputError,
                       match=r"etherplus_gemm_bwd refuses .*" + why):
        ops.etherplus_gemm_bwd(x, w, u1, v1, u2, v2, g, need_dw=False)
    if case != "g_shape":
        with pytest.raises(ops.KernelInputError,
                           match=r"etherplus_gemm refuses x \(.*" + why):
            ops.etherplus_gemm(x, w, u1, v1, u2, v2)
    if case not in ("g_shape", "float16"):
        with pytest.raises(ops.KernelInputError,
                           match="etherplus_merge refuses .*" + why):
            ops.etherplus_merge(w, u1, v1, u2, v2)


def test_cuda_backend_on_cpu_raises_without_running_the_plain_version(
        monkeypatch):
    x, w, u1, v1, u2, v2, _ = (None if a is None else _t(a)
                               for a in _inputs(10, 4, 96, 64, 8))
    ran = []
    for op in ("etherplus_gemm", "etherplus_merge"):
        monkeypatch.setitem(execute._REGISTRY, (op, "torch"),
                            lambda *a, op=op: ran.append(op))
    execute.reset_counters()
    with pytest.raises(execute.BackendError, match="only on CUDA tensors"):
        execute.dispatch("etherplus_gemm", "cuda", x, w, u1, v1, u2, v2)
    with pytest.raises(execute.BackendError, match="only on CUDA tensors"):
        execute.dispatch("etherplus_merge", "cuda", w, u1, v1, u2, v2)
    cfg = T.PEFTConfig(method="etherplus", n_blocks=8, backend="cuda")
    with pytest.raises(execute.BackendError):
        T.adapted_dense(x, w, None, {"u1": u1, "v1": v1, "u2": u2, "v2": v2},
                        cfg)
    assert ran == [] and execute.counters() == {}


@pytest.mark.parametrize("w_trains", [False, True])
@pytest.mark.parametrize("two_sided", [True, False])
def test_autograd_function_matches_vjp_of_the_plain_forward(two_sided,
                                                            w_trains):
    x, w, u1, v1, u2, v2, g = _inputs(11, 6, 96, 40, 8, two_sided)
    x3, g3 = _t(x).reshape(2, 3, 96), _t(g).reshape(2, 3, 40)
    adapters = [_tt(a) for a in (u1, v1, u2, v2)]
    leaves = [x3.clone().requires_grad_(),
              _t(w).requires_grad_(w_trains),
              *(None if a is None else a.clone().requires_grad_()
                for a in adapters)]
    execute.reset_counters()
    execute.EtherPlusGemm.apply(*leaves, "auto").backward(g3)
    primals = [x3, _t(w)] + [a for a in adapters if a is not None]
    _, vjp = torch.func.vjp(
        lambda *a: ref.ref_etherplus_gemm(*a[:4], *(a[4:] or (None, None))),
        *primals)
    want = vjp(g3)
    got = [leaf for leaf in leaves if leaf is not None]
    for name, leaf, wnt in zip(("dx", "dw", "du1", "dv1", "du2", "dv2"),
                               got, want):
        if name == "dw" and not w_trains:
            assert leaf.grad is None
            continue
        assert _max_err(_np(leaf.grad), _np(wnt)) < F32_TOL, name
    assert execute.counters() == {"etherplus_gemm.torch": 1,
                                  "etherplus_gemm_bwd.torch": 1}


def test_method_init_pair_merge_and_no_grad_serving():
    m = methods.get("etherplus")
    cfg = T.PEFTConfig(method="etherplus", n_blocks=8)
    a = m.init(torch.Generator().manual_seed(0), 96, 40, cfg, (3,), "cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "u1": (3, 8, 12), "v1": (3, 8, 12), "u2": (3, 8, 5), "v2": (3, 8, 5)}
    assert torch.equal(a["u1"], a["v1"]) and torch.equal(a["u2"], a["v2"])
    one = T.PEFTConfig(method="etherplus", n_blocks=8, two_sided=False)
    assert set(m.init(torch.Generator(), 96, 40, one, (), "cpu")) == {
        "u1", "v1"}
    # H⁺ = I at init: the adapted linear is the plain one
    x, w = torch.randn(4, 96), torch.randn(96, 40)
    first = {k: v[0] for k, v in a.items()}
    torch.testing.assert_close(m.dense(x, w, first, cfg), x @ w, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(m.merge(w, first, cfg), w, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="two_sided"):
        m.dense(x, w, {"u1": first["u1"], "v1": first["v1"]}, cfg)
    assert m.param_count(96, 40, cfg) == 2 * 96 + 2 * 40
    assert m.param_count(96, 40, one) == 2 * 96
    # serving pays nothing for autograd, even with grad-requiring leaves
    leaves = {k: v.clone().requires_grad_() for k, v in first.items()}
    execute.reset_counters()
    with torch.no_grad():
        assert m.dense(x, w, leaves, cfg).grad_fn is None
    assert m.dense(x, w, first, cfg).grad_fn is None
    assert execute.counters() == {"etherplus_gemm.torch": 2}


# ---------------------------------------------------------------------------
# Models and training against JAX, on bridged weights with v ≠ u
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _peft_pair(arch, **kw):
    return (JPEFTConfig(method="etherplus", n_blocks=8,
                        targets=jpeft_targets(arch), backend="jnp", **kw),
            T.PEFTConfig(method="etherplus", n_blocks=8,
                         targets=peft_targets(arch), **kw))


def _perturb_v(adapters, seed):
    """v1 and v2 drawn apart from u1 and u2 (the method's init has v = u)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        if path[-1].key.startswith("v"):
            return leaf + 0.5 * jnp.asarray(
                rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(move, adapters)


@pytest.mark.parametrize("arch,n_blocks,two_sided",
                         [("smollm-360m", 8, True), ("smollm-360m", 32, False),
                          ("llama-2-7b", 32, True), ("llama-2-7b", 8, False)])
def test_adapter_param_count_equal(arch, n_blocks, two_sided):
    cfg = jget_config(arch, "full")
    shapes = jax.eval_shape(lambda k: japi.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)
    jp, tp = _peft_pair(arch, two_sided=two_sided)
    jp = dataclasses.replace(jp, n_blocks=n_blocks)
    tp = dataclasses.replace(tp, n_blocks=n_blocks)
    assert (peft.adapters_param_count(meta, tp)
            == jpeft.adapters_param_count(shapes, jp))


@functools.lru_cache(maxsize=None)
def _serve_run(arch):
    """JAX and port prefill/decode on one smoke model; cached per arch."""
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = _perturb_v(jpeft.init_adapters(jax.random.PRNGKey(1), params,
                                              jp), 0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, P)).astype(
        np.int32)
    jcache, jlog = jax.jit(japi.prefill, static_argnums=(3, 4))(
        params, adapters, {"tokens": jnp.asarray(tokens)}, cfg, jp)
    jst = jax.jit(japi.decode_step, static_argnums=(4, 5))
    c = japi.pad_cache(jcache, cfg, P + GEN + 1)
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    jtoks, jsteps = [np.asarray(tok)], []
    for _ in range(GEN):
        lg, c = jst(params, adapters, c, tok, cfg, jp)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_merged_logits_match_jax(arch):
    r = _serve_run(arch)
    per_pass = 7 * r["cfg"].n_layers
    assert r["calls"] == {"etherplus_gemm.torch": per_pass,
                          "flash_attention.torch": r["cfg"].n_layers}
    assert r["merge_calls"] == {"etherplus_merge.torch": per_pass}
    assert _max_err(r["tlog"], r["jlog"]) < F32_TOL
    for t_lg, j_lg in zip(r["tsteps"], r["jsteps"]):
        assert _max_err(t_lg, j_lg) < F32_TOL
    assert _max_err(r["mlog"], r["tlog"]) < F32_TOL
    assert _max_err(r["mlog"], r["jlog"]) < F32_TOL
    # v ≠ u moved the logits off the plain model's (H⁺ = I would not)
    assert _max_err(r["tlog"], r["plain_log"]) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_adapter_grads_match_jax(arch):
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = _perturb_v(jpeft.init_adapters(jax.random.PRNGKey(1), params,
                                              jp), 1)
    batch = JStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=3).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a, b: japi.train_loss(params, a, b, cfg, jp), has_aux=True))(
        adapters, {k: jnp.asarray(v) for k, v in batch.items()})
    tadapters = bridge.to_torch(_np_tree(adapters))
    leaves = flatten_with_paths(tadapters)
    assert {p.rsplit("/", 1)[1] for p, _ in leaves} == {"u1", "v1", "u2",
                                                        "v2"}
    for _, leaf in leaves:
        leaf.requires_grad_()
    execute.reset_counters()
    tloss, _ = api.train_loss(
        bridge.to_torch(_np_tree(params)), tadapters,
        {k: torch.from_numpy(v).long() for k, v in batch.items()}, tcfg, tp)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) / float(jloss) < F32_TOL
    jg = dict(jflatten(jgrads))
    for path, leaf in leaves:
        assert _max_err(_np(leaf.grad), jg[path]) < GRAD_TOL, path
    per_pass = 7 * tcfg.n_layers
    # and each layer's attention, on its plain route under autograd
    assert execute.counters() == {"etherplus_gemm.torch": per_pass,
                                  "etherplus_gemm_bwd.torch": per_pass,
                                  "flash_attention.torch": tcfg.n_layers}


@functools.lru_cache(maxsize=None)
def _trajectories(arch):
    """5 AdamW/cosine steps of both packages from one JAX state."""
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch)
    jopt = jadamw(jsched.cosine(2e-3, N_STEPS, 2))
    topt = adamw(schedules.cosine(2e-3, N_STEPS, 2))
    jstate = jsteps.init_state(jax.random.PRNGKey(0), cfg, jp, jopt)
    jstate = dict(jstate, adapters=_perturb_v(jstate["adapters"], 2))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_cosine_trajectory_matches_jax(arch):
    r = _trajectories(arch)
    assert np.abs(r["tl"] - r["jl"]).max() / np.abs(r["jl"]).max() < GRAD_TOL
    jfin = dict(jflatten(_np_tree(r["jstate"]["adapters"])))
    init = dict(jflatten(r["init"]))
    for path, leaf in flatten_with_paths(r["tstate"]["adapters"]):
        assert _max_err(_np(leaf) - init[path],
                        jfin[path] - init[path]) < GRAD_TOL, path
    assert int(r["tstate"]["step"]) == N_STEPS


# ---------------------------------------------------------------------------
# The trainer, checkpoints and CLIs with four-leaf adapters (port only)
# ---------------------------------------------------------------------------

def _trainer(tmp_path, name, **kw):
    cfg = get_config("smollm-360m", "smoke")
    _, tp = _peft_pair("smollm-360m")
    return Trainer(cfg, tp, adamw(schedules.cosine(2e-3, 4, 1)),
                   ckpt_dir=str(tmp_path / name), ckpt_every=2, seed=0,
                   device="cpu", **kw)


def test_trainer_resume_with_etherplus_adapters_ends_bitwise_equal(tmp_path):
    stream = SyntheticLMStream(vocab=512, batch=B, seq_len=S, seed=0)
    ref_run = _trainer(tmp_path, "ref")
    ref_run.fit(stream, steps=4)
    ref_run.close()
    crashed = _trainer(tmp_path, "run", fail_at_step=3)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        crashed.fit(stream, steps=4)
    crashed.close()
    assert latest_step(str(tmp_path / "run")) == 2
    resumed = _trainer(tmp_path, "run")
    assert resumed.step == 2
    resumed.fit(stream, steps=4)
    resumed.close()
    paths = [p for p, _ in flatten_with_paths(ref_run.state["adapters"])]
    assert {p.rsplit("/", 1)[1] for p in paths} == {"u1", "v1", "u2", "v2"}
    for key in ("adapters", "opt_state", "step"):
        want = dict(flatten_with_paths(ref_run.state[key]))
        got = flatten_with_paths(resumed.state[key])
        assert len(got) == len(want)
        for path, leaf in got:
            assert torch.equal(leaf, want[path]), f"{key}/{path}"
    # the adapters moved off H⁺ = I: v no longer equals u
    a = ref_run.state["adapters"]["units"]["pos0"]["mlp"]["down_proj"]
    assert not torch.equal(a["u1"], a["v1"])


@pytest.mark.parametrize("merged", [False, True])
def test_serve_cli_runs_etherplus_on_cpu(merged, capsys):
    res = serve.main(["--device", "cpu", "--method", "etherplus", "--gen",
                      "2", "--batch", "2", "--prompt-len", "8"]
                     + (["--merged"] if merged else []))
    out = capsys.readouterr().out
    assert res["tokens"].shape == (2, 3) and torch.isfinite(
        res["logits"]).all()
    per_forward = 7 * 4
    want = ({"etherplus_merge.torch": per_forward} if merged else
            {"etherplus_gemm.torch": per_forward * res["forwards"]})
    want["flash_attention.torch"] = 4 * res["forwards"]
    assert f"dispatch counters: {want}" in out


def test_train_cli_runs_etherplus_on_cpu(capsys):
    metrics = train.main(["--device", "cpu", "--variant", "smoke",
                          "--method", "etherplus", "--steps", "2",
                          "--batch", "2", "--seq-len", "16"])
    assert "done @ step 2" in capsys.readouterr().out
    assert np.isfinite(metrics["loss"]) and metrics["step"] == 2
