"""The port's non-activation PEFT modes held against the JAX package on
the CPU: the plain versions of the merge backwards (``merge_left_bwd`` at
rank 1 and 2, ``merge_right_bwd``, the ETHER and ETHER+ compositions)
against ``repro.kernels.ref`` and the interpret-mode Pallas kernels of
``repro.kernels.merge_bwd``; the paper-literal primitives; every mode of
every method against JAX ``adapted_dense`` in the same mode (activation ≡
weight ≡ blockgemm ≡ merged); ``train_loss`` with its adapter gradients
and 5-step AdamW/cosine trajectories in weight and blockgemm modes
against the JAX package on the same weights (``bridge``); and the repairs
that came with the modes: ``serve --tenants`` ≤ 0, an unknown method and
an unknown mode raise as JAX does.

Every method's init is its identity or hides part of it (ETHER+'s v = u,
DeLoRA's and LoRA's b = 0, HyperAdapt's r = c = 1, OFT's R = 0, Naive's
m = I): every comparison here moves the adapters off it first, from a
seed, and DeLoRA starts from b ≠ 0 (the reference's gradient is NaN at
b = 0, ROADMAP.md Queue 3)."""

import functools
import sys

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
from repro.kernels import ref as jref
from repro.kernels.merge_bwd import (merge_left_bwd_pallas,
                                     merge_right_bwd_pallas)
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch import NotPortedError, bridge
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute, methods, peft
from repro_torch.core import transforms as T
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, steps, train
from repro_torch.models import api
from repro_torch.optim import adamw, schedules

MODES = ("activation", "weight", "blockgemm")
# float32, normalised max error max|a − b| / max|b|: the same sums in
# another order (the merges' column dots over up to 80 rows, the dense
# blocks' GEMMs, OFT's solve)
F32_TOL = 1e-5
# the same function computed two ways inside one package (JAX's own
# test_mode_equivalence holds its modes to atol 2e-4 at these sizes):
# the factored merge against the dense blocks, the reflection of x
# against that of W, in f32 at unit-scale inputs
MODE_TOL = 2e-5
# gradients through four layers, softmax and cross-entropy
GRAD_TOL = 1e-4
# bf16 (8 mantissa bits), relative Frobenius: W, G and dW rounded to bf16
# on both sides, the f32 sums in another order
BF16_TOL = 2e-2
B, S, N_STEPS = 2, 16, 5


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np(t):
    return t.detach().float().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _merge_inputs(seed, d, f, n, n_out=None):
    """w (d, f), u1, v1 (n, d/n) with v drawn apart from u (v = u hides
    rank 2), u2, v2 (n_out, f/n_out) when n_out is given, and g (d, f)."""
    rng = np.random.default_rng(seed)
    w = _draw(rng, d, f) / np.float32(np.sqrt(d))
    u, v = _draw(rng, n, d // n), _draw(rng, n, d // n)
    u2 = v2 = None
    if n_out is not None:
        u2, v2 = _draw(rng, n_out, f // n_out), _draw(rng, n_out, f // n_out)
    return w, u, v, u2, v2, _draw(rng, d, f)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


# ---------------------------------------------------------------------------
# The plain merge backwards against the JAX package
# ---------------------------------------------------------------------------

# (d, f, n): left db 10, 30 and 80 at odd f
LEFT = [(80, 40, 8), (240, 56, 8), (160, 24, 2)]
# (d, f, n_out): right db_out 10, 30 and 80 at odd d
RIGHT = [(40, 80, 8), (56, 240, 8), (24, 160, 2)]


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("d,f,n", LEFT)
def test_plain_merge_left_bwd_matches_jax(d, f, n, rank):
    w, u, v, _, _, g = _merge_inputs(0, d, f, n)
    v = v if rank == 2 else None
    port = ref.ref_merge_left_bwd(_t(w), _t(u), _t(g), _t(v))
    if rank == 1:
        want = jref.ref_ether_merge_bwd(_j(w), _j(u), _j(g))
    else:
        want = jref.ref_etherplus_merge_bwd(_j(w), _j(u), _j(v), None, None,
                                            _j(g))[:3]
    kernel = merge_left_bwd_pallas(_j(w), _j(u), _j(g), _j(v),
                                   interpret=True)
    assert len(port) == len(want) == len(kernel) == rank + 1
    for name, p, a, k in zip(("dw", "du", "dv"), port, want, kernel):
        assert p.dtype == torch.float32
        assert _max_err(_np(p), a) < F32_TOL, name
        assert _max_err(_np(p), k) < F32_TOL, name
    # without dW: the same du (dv), and no dW
    lean = ref.ref_merge_left_bwd(_t(w), _t(u), _t(g), _t(v), need_dw=False)
    assert lean[0] is None
    for a, b in zip(lean[1:], port[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d,f,n_out", RIGHT)
def test_plain_merge_right_bwd_matches_jax(d, f, n_out):
    w, _, _, u2, v2, g = _merge_inputs(1, d, f, 1, n_out)
    # each row of w takes the rank-2 update: the plain right backward is
    # the rank-2 reflection backward of w's rows
    port = ref.ref_etherplus_reflect_bwd(_t(w), _t(u2), _t(v2), _t(g))
    want = jax.vjp(lambda w, u, v: jT.etherplus_weight(w, u, v, "right"),
                   _j(w), _j(u2), _j(v2))[1](_j(g))
    kernel = merge_right_bwd_pallas(_j(w), _j(u2), _j(v2), _j(g),
                                    interpret=True)
    for name, p, a, k in zip(("dw", "du", "dv"), port, want, kernel):
        assert _max_err(_np(p), a) < F32_TOL, name
        assert _max_err(_np(p), k) < F32_TOL, name


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("d,f,n", [(80, 40, 8), (240, 160, 8)])
def test_plain_merge_compositions_match_jax(d, f, n, two_sided):
    n_out = T.resolve_blocks(n, f) if two_sided else None
    w, u, v, u2, v2, g = _merge_inputs(2, d, f, n, n_out)
    port = ref.ref_etherplus_merge_bwd(*map(_t, (w, u, v, u2, v2, g)))
    want = jref.ref_etherplus_merge_bwd(*map(_j, (w, u, v, u2, v2, g)))
    for name, p, a in zip(("dw", "du1", "dv1", "du2", "dv2"), port, want):
        if not two_sided and name in ("du2", "dv2"):
            assert p is None and a is None
            continue
        assert _max_err(_np(p), a) < F32_TOL, name
    dw, du = ref.ref_ether_merge_bwd(_t(w), _t(u), _t(g))
    jdw, jdu = jref.ref_ether_merge_bwd(_j(w), _j(u), _j(g))
    assert _max_err(_np(dw), jdw) < F32_TOL
    assert _max_err(_np(du), jdu) < F32_TOL
    # the wrappers on CPU tensors run these plain versions
    got = ops.etherplus_merge_bwd(*map(_t, (w, u, v, u2, v2, g)),
                                  need_dw=False)
    assert got[0] is None
    for a, b in zip(got[1:], port[1:]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_plain_merge_bwds_match_interpret_pallas_in_bf16():
    d, f, n, n_out = 240, 160, 8, 8
    w, u, v, u2, v2, g = _merge_inputs(3, d, f, n, n_out)
    bt = torch.bfloat16
    for vv in (None, v):
        port = ref.ref_merge_left_bwd(_t(w, bt), _t(u), _t(g, bt), _t(vv))
        kernel = merge_left_bwd_pallas(_j(w, jnp.bfloat16), _j(u),
                                       _j(g, jnp.bfloat16), _j(vv),
                                       interpret=True)
        assert port[0].dtype == bt and port[1].dtype == torch.float32
        for p, k in zip(port, kernel):
            assert _frob(_np(p), np.asarray(k, np.float32)) < BF16_TOL
    port = ref.ref_etherplus_reflect_bwd(_t(w, bt), _t(u2), _t(v2),
                                         _t(g, bt))
    kernel = merge_right_bwd_pallas(_j(w, jnp.bfloat16), _j(u2), _j(v2),
                                    _j(g, jnp.bfloat16), interpret=True)
    assert port[0].dtype == bt
    for p, k in zip(port, kernel):
        assert _frob(_np(p), np.asarray(k, np.float32)) < BF16_TOL


@pytest.mark.parametrize("case", ["g_dtype", "g_shape", "u_shape",
                                  "v_shape", "right_split"])
def test_merge_bwd_wrappers_refuse_what_the_kernels_do_not_take(case):
    w, u, v, u2, v2, g = (_t(a) for a in _merge_inputs(4, 80, 40, 8, 8))
    why = {"g_dtype": "g must be", "g_shape": "g must be",
           "u_shape": "n·db = 80", "v_shape": "v must be",
           "right_split": "n·db = 40"}[case]
    with pytest.raises(ops.KernelInputError, match=why):
        if case == "g_dtype":
            ops.merge_left_bwd(w, u, g.to(torch.bfloat16), need_dw=True)
        elif case == "g_shape":
            ops.merge_left_bwd(w, u, g[:, :-1].contiguous(), need_dw=True)
        elif case == "u_shape":
            ops.merge_left_bwd(w, u[:, :-1].contiguous(), g, need_dw=True)
        elif case == "v_shape":
            ops.merge_left_bwd(w, u, g, v[:-1].contiguous(), need_dw=True)
        else:
            ops.merge_right_bwd(w, u2[:-1].contiguous(),
                                v2[:-1].contiguous(), g)


# ---------------------------------------------------------------------------
# The autograd Functions against autograd of the plain forward
# ---------------------------------------------------------------------------

def _autograd_oracle(fwd, inputs, g):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    fwd(*leaves).backward(g)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("method", ["ether", "etherplus", "etherplus_1s",
                                    "delora", "hyperadapt"])
def test_merge_functions_match_autograd_of_the_plain_merge(method):
    rng = np.random.default_rng(5)
    d, f, n = 96, 40, 8
    w, g = _t(_draw(rng, d, f) / np.float32(10)), _t(_draw(rng, d, f))
    if method == "ether":
        args = [_t(_draw(rng, n, d // n))]
        fn, plain, op = execute.EtherMerge, ref.ref_ether_merge, "ether_merge"
    elif method.startswith("etherplus"):
        args = [_t(_draw(rng, n, d // n)) for _ in range(2)]
        if method == "etherplus":
            args += [_t(_draw(rng, 8, f // 8)) for _ in range(2)]
        fn, plain, op = (execute.EtherPlusMerge, ref.ref_etherplus_merge,
                         "etherplus_merge")
    elif method == "delora":
        args = [_t(_draw(rng, d, 4)), _t(_draw(rng, 4, f)),
                _t(np.abs(_draw(rng, 4)) + 0.1)]
        fn, plain, op = execute.DeloraMerge, ref.ref_delora_merge, \
            "delora_merge"
    else:
        args = [_t(1 + 0.2 * _draw(rng, d)), _t(1 + 0.2 * _draw(rng, f))]
        fn, plain, op = execute.HyperAdaptMerge, ref.ref_hyperadapt_merge, \
            "hyperadapt_merge"
    want = _autograd_oracle(plain, [w, *args], g)
    for w_trains in (True, False):
        leaves = [w.clone().requires_grad_(w_trains)] + [
            a.clone().requires_grad_() for a in args]
        extra = ([None, None] if method == "etherplus_1s" else [])
        execute.reset_counters()
        fn.apply(*leaves, *extra, "auto").backward(g)
        assert execute.counters() == {f"{op}.torch": 1,
                                      f"{op}_bwd.torch": 1}
        if w_trains:
            assert _max_err(_np(leaves[0].grad), _np(want[0])) < F32_TOL
        else:
            assert leaves[0].grad is None
        for i, (leaf, wg) in enumerate(zip(leaves[1:], want[1:])):
            assert _max_err(_np(leaf.grad), _np(wg)) < F32_TOL, i


# ---------------------------------------------------------------------------
# The paper-literal primitives
# ---------------------------------------------------------------------------

def test_literal_primitives_match_jax():
    rng = np.random.default_rng(6)
    n, db, d, f = 4, 6, 24, 20
    u = _draw(rng, n, db)
    for coeff, sign in ((2.0, -1.0), (1.0, -1.0), (1.0, 1.0)):
        assert _max_err(
            _np(T.householder_blocks(_t(u), coeff=coeff, sign=sign)),
            jT.householder_blocks(_j(u), coeff=coeff, sign=sign)) < F32_TOL
    blocks = _draw(rng, n, db, db)
    lw, rw = _draw(rng, d, f), _draw(rng, f, d)
    assert _max_err(_np(T.block_diag_matmul(_t(blocks), _t(lw))),
                    jT.block_diag_matmul(_j(blocks), _j(lw))) < F32_TOL
    assert _max_err(_np(T.block_diag_matmul(_t(blocks), _t(rw), "right")),
                    jT.block_diag_matmul(_j(blocks), _j(rw), "right")) \
        < F32_TOL
    np.testing.assert_array_equal(
        _np(T.materialize_block_diag(_t(blocks))),
        np.asarray(jT.materialize_block_diag(_j(blocks))))
    pair = (_draw(rng, n, db, db), _draw(rng, n, db, db))
    assert _max_err(_np(T._addmul(tuple(map(_t, pair)))),
                    jT._addmul(tuple(map(_j, pair)))) < F32_TOL
    # the dense blocks reproduce the factored reflection (§3.4)
    assert _max_err(_np(T.block_diag_matmul(T.householder_blocks(_t(u)),
                                            _t(lw))),
                    _np(T.reflect_weight(_t(lw), _t(u)))) < MODE_TOL


# ---------------------------------------------------------------------------
# Every mode of every method against JAX adapted_dense
# ---------------------------------------------------------------------------

EQUIV = ["ether", "etherplus", "oft", "naive", "lora", "delora",
         "hyperadapt"]


def _adapter(method, d, f, n, seed):
    """One adapted linear's adapter, numpy, moved off the method's
    identity from a seed (ETHER+'s v apart from u; DeLoRA's b ≠ 0)."""
    cfg = T.PEFTConfig(method=method, n_blocks=n, rank=4, alpha=4.0)
    shapes = T.init_adapter(torch.Generator().manual_seed(0), method, d, f,
                            cfg)
    rng = np.random.default_rng(seed)
    out = {}
    for k, leaf in shapes.items():
        x = _draw(rng, *leaf.shape)
        if method == "oft":
            x = 0.1 * x
        elif method == "naive":
            x = np.eye(leaf.shape[-1], dtype=np.float32) + 0.1 * x
        elif method in ("lora", "delora") and k == "a":
            x = x / np.float32(np.sqrt(d))
        elif k == "lam":
            x = np.float32(2.0) + np.float32(0.5) * x
        elif method == "hyperadapt":
            x = 1 + 0.2 * x
        out[k] = np.asarray(x, np.float32)
    return out


@pytest.mark.parametrize("d,f,n", [(16, 24, 4), (24, 40, 8)])
@pytest.mark.parametrize("method", EQUIV)
def test_mode_equivalence_matches_jax(method, d, f, n):
    """The port's counterpart of tests/test_transforms.py::
    test_mode_equivalence: activation ≡ weight ≡ blockgemm ≡ merged, each
    mode against JAX ``adapted_dense`` in the same mode."""
    a = _adapter(method, d, f, n, seed=d)
    rng = np.random.default_rng(7)
    x, w, b = _draw(rng, 5, d), _draw(rng, d, f), _draw(rng, f)
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ys = {}
    for mode in MODES:
        tcfg = T.PEFTConfig(method=method, n_blocks=n, rank=4, alpha=4.0,
                            mode=mode)
        jcfg = JPEFTConfig(method=method, n_blocks=n, rank=4, alpha=4.0,
                           mode=mode, backend="jnp")
        ys[mode] = T.adapted_dense(_t(x), _t(w), _t(b), ta, tcfg)
        want = jT.adapted_dense(_j(x), _j(w), _j(b), ja, jcfg)
        assert _max_err(_np(ys[mode]), want) < F32_TOL, mode
    merged = _t(x) @ T.merge_weight(_t(w), ta, tcfg) + _t(b)
    jmerged = jT.merge_weight(_j(w), ja, jcfg)
    assert _max_err(_np(T.merge_weight(_t(w), ta, tcfg)), jmerged) < F32_TOL
    literal = T.merge_weight(_t(w), ta, tcfg, literal=True)
    assert _max_err(_np(literal), jT.merge_weight(_j(w), ja, jcfg,
                                                  literal=True)) < F32_TOL
    for mode in ("weight", "blockgemm"):
        assert _max_err(_np(ys[mode]), _np(ys["activation"])) < MODE_TOL
    assert _max_err(_np(merged), _np(ys["activation"])) < MODE_TOL


@pytest.mark.parametrize("method", EQUIV)
def test_materialize_transform_matches_jax(method):
    d, f, n = 16, 24, 4
    a = _adapter(method, d, f, n, seed=3)
    tcfg = T.PEFTConfig(method=method, n_blocks=n, rank=4, alpha=4.0)
    jcfg = JPEFTConfig(method=method, n_blocks=n, rank=4, alpha=4.0)
    got = T.materialize_transform({k: torch.from_numpy(v)
                                   for k, v in a.items()}, tcfg, d, f)
    want = jT.materialize_transform({k: jnp.asarray(v)
                                     for k, v in a.items()}, jcfg, d, f)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.shape == w.shape
            assert _max_err(_np(g), w) < F32_TOL


def test_bank_serving_refuses_the_other_modes_as_jax_does():
    a = {"u": torch.randn(3, 4, 6), "ids": torch.tensor([0, 2])}
    for mode in ("weight", "blockgemm"):
        cfg = T.PEFTConfig(method="ether", n_blocks=4, mode=mode)
        with pytest.raises(ValueError, match="requires mode='activation'"):
            T.adapted_dense(torch.randn(2, 3, 24), torch.randn(24, 8), None,
                            a, cfg)


# ---------------------------------------------------------------------------
# train_loss, gradients and trajectories against JAX in both modes
# ---------------------------------------------------------------------------

ARCHS = ["smollm-360m", "llama-2-7b"]
# (arch, method, mode) of the gradient checks: the reflections in both
# modes on both configs; the other kernel-backed methods and OFT in weight
# mode (their blockgemm is their weight mode)
GRAD_CASES = ([(arch, m, mode) for arch in ARCHS
               for m in ("ether", "etherplus")
               for mode in ("weight", "blockgemm")]
              + [("smollm-360m", m, "weight")
                 for m in ("delora", "hyperadapt", "oft")])
TRAJ_CASES = ([("ether", mode) for mode in ("weight", "blockgemm")]
              + [("etherplus", mode) for mode in ("weight", "blockgemm")]
              + [("delora", "weight"), ("hyperadapt", "weight")])


def _peft_pair(arch, method, mode):
    kw = dict(method=method, n_blocks=8, rank=4, alpha=4.0, mode=mode)
    return (JPEFTConfig(targets=jpeft_targets(arch), backend="jnp", **kw),
            T.PEFTConfig(targets=peft_targets(arch), **kw))


def _perturb(adapters, method, seed):
    """Move every method off its identity init: ETHER+'s v apart from u,
    DeLoRA's b (≠ 0) and λ, HyperAdapt's r and c, OFT's R."""
    rng = np.random.default_rng(seed)
    spread = {("etherplus", "v1"): 0.5, ("etherplus", "v2"): 0.5,
              ("delora", "b"): 0.5, ("delora", "lam"): 2.0,
              ("hyperadapt", "r"): 0.2, ("hyperadapt", "c"): 0.2,
              ("oft", "r"): 0.1}

    def move(path, leaf):
        sd = spread.get((method, path[-1].key))
        if sd is None:
            return leaf
        return leaf + sd * jnp.asarray(rng.standard_normal(leaf.shape),
                                       leaf.dtype)
    return jax.tree_util.tree_map_with_path(move, adapters)


@pytest.mark.parametrize("arch,method,mode", GRAD_CASES)
def test_train_loss_and_adapter_grads_match_jax(arch, method, mode):
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch, method, mode)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = _perturb(jpeft.init_adapters(jax.random.PRNGKey(1), params,
                                            jp), method, 1)
    batch = JStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=3).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a, b: japi.train_loss(params, a, b, cfg, jp), has_aux=True))(
        adapters, {k: jnp.asarray(v) for k, v in batch.items()})
    tadapters = bridge.to_torch(_np_tree(adapters))
    leaves = flatten_with_paths(tadapters)
    for _, leaf in leaves:
        leaf.requires_grad_()
    execute.reset_counters()
    tloss, _ = api.train_loss(
        bridge.to_torch(_np_tree(params)), tadapters,
        {k: torch.from_numpy(v).long() for k, v in batch.items()}, tcfg, tp)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) / float(jloss) < F32_TOL
    jg = dict(jflatten(jgrads))
    assert {p for p, _ in leaves} == set(jg)
    for path, leaf in leaves:
        assert _max_err(_np(leaf.grad), jg[path]) < GRAD_TOL, path
    per_pass = 7 * tcfg.n_layers            # remat "none" at smoke size
    op = {"ether": "ether_merge", "etherplus": "etherplus_merge",
          "delora": "delora_merge", "hyperadapt": "hyperadapt_merge"}.get(
        method)
    want = ({} if mode == "blockgemm" or op is None else
            {f"{op}.torch": per_pass, f"{op}_bwd.torch": per_pass})
    assert execute.counters() == want


@functools.lru_cache(maxsize=None)
def _trajectories(method, mode):
    """5 AdamW/cosine steps of both packages from one JAX state."""
    arch = "smollm-360m"
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch, method, mode)
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


@pytest.mark.parametrize("method,mode", TRAJ_CASES)
def test_adamw_cosine_trajectory_matches_jax(method, mode):
    r = _trajectories(method, mode)
    assert np.isfinite(r["tl"]).all()
    assert np.abs(r["tl"] - r["jl"]).max() / np.abs(r["jl"]).max() < GRAD_TOL
    jfin = dict(jflatten(_np_tree(r["jstate"]["adapters"])))
    init = dict(jflatten(r["init"]))
    for path, leaf in flatten_with_paths(r["tstate"]["adapters"]):
        assert _max_err(_np(leaf) - init[path],
                        jfin[path] - init[path]) < GRAD_TOL, path
    assert int(r["tstate"]["step"]) == N_STEPS


# ---------------------------------------------------------------------------
# The CLIs and the repairs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["weight", "blockgemm"])
@pytest.mark.parametrize("method", methods.available())
def test_train_cli_trains_every_method_in_both_modes(method, mode, capsys):
    metrics = train.main(["--device", "cpu", "--variant", "smoke",
                          "--method", method, "--peft-mode", mode,
                          "--steps", "2", "--batch", "2", "--seq-len", "16",
                          "--rank", "4"])
    assert "done @ step 2" in capsys.readouterr().out
    assert np.isfinite(metrics["loss"]) and metrics["step"] == 2
    assert np.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0


def test_serve_with_tenants_below_one_serves_single_tenant(capsys,
                                                           monkeypatch):
    """``--tenants -2``: the JAX CLI tests ``args.tenants > 0`` and serves
    one tenant; so does the port."""
    monkeypatch.setattr(sys, "argv", ["serve", "--variant", "smoke",
                                      "--tenants", "-2", "--gen", "2"])
    jserve.main()
    jout = capsys.readouterr().out
    assert "adapter bank" not in jout and "generated:" in jout
    res = serve.main(["--device", "cpu", "--variant", "smoke", "--tenants",
                      "-2", "--gen", "2"])
    out = capsys.readouterr().out
    assert "adapter bank" not in out and "generated:" in out
    assert res["tokens"].shape == (4, 3)
    assert f"dispatch counters: {{'householder_gemm.torch': " \
           f"{7 * 4 * res['forwards']}}}" in out
    m = serve.build(device="cpu", tenants=-2)
    assert m["tenant_ids"] is None
    assert not isinstance(m["adapters"], peft.AdapterBank)


def test_unknown_method_raises_jax_unknown_method_error():
    with pytest.raises(jmethods.UnknownMethodError) as jerr:
        JPEFTConfig(method="nope")
    with pytest.raises(methods.UnknownMethodError) as terr:
        T.PEFTConfig(method="nope")
    assert isinstance(jerr.value, ValueError)
    assert isinstance(terr.value, ValueError)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert terr.value.name == jerr.value.name == "nope"
    assert terr.value.valid == tuple(m for m in jerr.value.valid
                                     if m != "vera")
    assert str(terr.value) == str(jerr.value).replace(", vera", "")
    # a method of the JAX registry that the port lacks is not unknown
    with pytest.raises(NotPortedError, match="ROADMAP.md"):
        T.PEFTConfig(method="vera")


@pytest.mark.parametrize("mode", ["nope", "Weight", ""])
def test_unknown_mode_raises_value_error_as_jax_does(mode):
    with pytest.raises(ValueError, match=f"unknown mode {mode!r}") as jerr:
        JPEFTConfig(mode=mode)
    with pytest.raises(ValueError, match=f"unknown mode {mode!r}") as terr:
        T.PEFTConfig(mode=mode)
    assert str(terr.value) == str(jerr.value)
    assert not isinstance(terr.value, NotPortedError)
    for mode in MODES:                     # and the three modes are taken
        assert T.PEFTConfig(mode=mode).mode == mode
