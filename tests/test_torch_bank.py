"""Multi-tenant adapter-bank serving of the port held against the JAX
package on the CPU: the plain versions of the four bank kernels
(``householder_gemm_batched``, ``etherplus_reflect_batched``,
``delora_gemm_batched``, ``hyperadapt_gemm_batched``) against
``repro.kernels.ref`` and the interpret-mode Pallas kernels;
``AdapterBank`` (stack, select, request, with_capacity, replace_slot,
size_bytes) and ``validate_tenant_ids`` against ``repro.core.peft``;
``adapted_dense``'s bank branch; ``prefill`` and ``decode_step`` with
``tenant_ids`` against the JAX package's on bridged weights; and, port
only, each bank row against single-tenant serving of its tenant, the
wrappers' checks and ``serve --tenants``.

Identity at init hides a wrong gather (ETHER+'s v = u, DeLoRA's b = 0,
HyperAdapt's r = c = 1, and a kernel that served one tenant for all rows
would still agree with itself), so every tenant here comes from its own
seed and is moved off its method's identity, the ids hold two different
tenants, one tenant twice and the last row A − 1, and the tests require
distinct tenants' outputs to differ."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import peft_targets as jpeft_targets
from repro.core import peft as jpeft
from repro.core import transforms as jT
from repro.core.transforms import PEFTConfig as JPEFTConfig
from repro.kernels import ref as jref
from repro.kernels.delora_gemm import delora_gemm_batched_pallas
from repro.kernels.etherplus_reflect_batched import \
    etherplus_reflect_batched_pallas
from repro.kernels.householder_gemm_batched import \
    householder_gemm_batched_pallas
from repro.kernels.hyperadapt_gemm import hyperadapt_gemm_batched_pallas
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute, methods, peft
from repro_torch.core import transforms as T
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import api

ARCHS = ["smollm-360m", "llama-2-7b"]
BANK_METHODS = ["ether", "etherplus", "delora", "hyperadapt"]
# (B, S, d, f, n, A): a tileable shape, decode (S = 1) and a ragged S = 33
# on odd widths (no dim a power of two, f = 70 against every tile); A > B
SHAPES = [(3, 16, 256, 128, 8, 5), (4, 1, 128, 256, 4, 6),
          (3, 33, 96, 70, 8, 4)]
RANKS = [1, 8, 13]
# float32, normalised max error max|a − b| / max|b|: the same f32 sums (up
# to 256 terms) in another order
F32_TOL = 1e-5
# the logits of the four-layer smoke models, prefill and decode: f32 sums
# in another order through four layers (test_torch_methods.py measured up
# to 1.44e-5 there)
MODEL_TOL = 3e-5
# bf16, relative Frobenius.  The jnp refs cast û (and DeLoRA's a, b, s,
# HyperAdapt's r, c) to x's dtype first and round every intermediate
# (src/repro/kernels/ref.py:30-32); the Pallas kernels compute in f32 and
# round once, as the port does
BF16_TOL = {"jnp": 2e-2, "pallas": 1e-3}
B, P, GEN, TENANTS = 4, 8, 3, 6


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _ids(b, a):
    """Unsorted, one tenant twice, the last tenant A − 1."""
    return np.array([a - 1, 1, a - 1, 0][:b], np.int32)


def _bank_inputs(seed, b, s, d, f, n, a, r=8):
    """x, w and every method's bank operands (each tenant off its
    identity: v apart from u, b ≠ 0, r and c about 1)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    n_out = T.resolve_blocks(n, f)
    return {"x": draw(b, s, d), "w": draw(d, f) / np.float32(np.sqrt(d)),
            "u": draw(a, n, d // n), "v": draw(a, n, d // n),
            "u2": draw(a, n_out, f // n_out),
            "v2": draw(a, n_out, f // n_out),
            "a": draw(a, d, r), "b": draw(a, r, f),
            "s": np.abs(draw(a, r)) + np.float32(0.1),
            "r": 1 + 0.3 * draw(a, d), "c": 1 + 0.3 * draw(a, f),
            "ids": _ids(b, a)}


def _both(k, names, dtype=torch.float32, jdtype=jnp.float32):
    """The named operands as torch tensors and as jnp arrays (activations
    in ``dtype``; banks float32, DeLoRA's s in the activations' dtype)."""
    act = ("x", "w", "y", "s")
    tt = [torch.from_numpy(k[nm]) if nm == "ids" else
          _t(k[nm], dtype if nm in act else torch.float32) for nm in names]
    jj = [jnp.asarray(k[nm]) if nm == "ids" else
          jnp.asarray(k[nm], jdtype if nm in act else jnp.float32)
          for nm in names]
    return tt, jj


# ---------------------------------------------------------------------------
# The plain versions against repro.kernels.ref and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d,f,n,a", SHAPES)
def test_householder_gemm_batched_matches_jax(b, s, d, f, n, a):
    k = _bank_inputs(0, b, s, d, f, n, a)
    (x, w, u, ids), (jx, jw, ju, jids) = _both(k, ("x", "w", "u", "ids"))
    got = ref.ref_householder_gemm_batched(x, w, u, ids)
    assert got.shape == (b, s, f)
    assert _max_err(got, jref.ref_householder_gemm_batched(jx, jw, ju, jids)
                    ) < F32_TOL
    assert _max_err(got, householder_gemm_batched_pallas(
        jx, jw, ju, jids, interpret=True)) < F32_TOL
    # the rows of one tenant (0 and 2) agree with a single-tenant product
    assert _max_err(got[0], ref.ref_householder_gemm(x[0], w, u[a - 1])
                    ) < F32_TOL


@pytest.mark.parametrize("side", ["in", "out"])
@pytest.mark.parametrize("b,s,d,f,n,a", SHAPES)
def test_etherplus_reflect_batched_matches_jax(b, s, d, f, n, a, side):
    """On the input features (u1/v1 over d) and, as the two-sided bank
    applies it, on the output features (u2/v2 over f)."""
    k = _bank_inputs(1, b, s, d, f, n, a)
    if side == "out":
        k = {**k, "x": np.asarray(k["x"] @ k["w"], np.float32),
             "u": k["u2"], "v": k["v2"]}
    (x, u, v, ids), (jx, ju, jv, jids) = _both(k, ("x", "u", "v", "ids"))
    got = ref.ref_etherplus_reflect_batched(x, u, v, ids)
    assert got.shape == x.shape
    assert _max_err(got, jref.ref_etherplus_reflect_batched(jx, ju, jv, jids)
                    ) < F32_TOL
    assert _max_err(got, etherplus_reflect_batched_pallas(
        jx, ju, jv, jids, interpret=True)) < F32_TOL


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("b,s,d,f,n,a", SHAPES)
def test_delora_gemm_batched_matches_jax(b, s, d, f, n, a, r):
    k = _bank_inputs(2, b, s, d, f, n, a, r)
    names = ("x", "w", "a", "b", "s", "ids")
    tt, jj = _both(k, names)
    got = ref.ref_delora_gemm_batched(*tt)
    assert got.shape == (b, s, f)
    assert _max_err(got, jref.ref_delora_gemm_batched(*jj)) < F32_TOL
    assert _max_err(got, delora_gemm_batched_pallas(*jj, interpret=True)
                    ) < F32_TOL


@pytest.mark.parametrize("b,s,d,f,n,a", SHAPES)
def test_hyperadapt_gemm_batched_matches_jax(b, s, d, f, n, a):
    k = _bank_inputs(3, b, s, d, f, n, a)
    tt, jj = _both(k, ("x", "w", "r", "c", "ids"))
    got = ref.ref_hyperadapt_gemm_batched(*tt)
    assert got.shape == (b, s, f)
    assert _max_err(got, jref.ref_hyperadapt_gemm_batched(*jj)) < F32_TOL
    assert _max_err(got, hyperadapt_gemm_batched_pallas(*jj, interpret=True)
                    ) < F32_TOL


_OPS = {"householder_gemm_batched": ("x", "w", "u", "ids"),
        "etherplus_reflect_batched": ("x", "u", "v", "ids"),
        "delora_gemm_batched": ("x", "w", "a", "b", "s", "ids"),
        "hyperadapt_gemm_batched": ("x", "w", "r", "c", "ids")}
_PALLAS = {"householder_gemm_batched": householder_gemm_batched_pallas,
           "etherplus_reflect_batched": etherplus_reflect_batched_pallas,
           "delora_gemm_batched": delora_gemm_batched_pallas,
           "hyperadapt_gemm_batched": hyperadapt_gemm_batched_pallas}


@pytest.mark.parametrize("op", list(_OPS))
def test_bf16_bank_plain_versions_match_jax(op):
    k = _bank_inputs(4, 3, 16, 256, 128, 8, 5)
    tt, jj = _both(k, _OPS[op], torch.bfloat16, jnp.bfloat16)
    got = getattr(ref, f"ref_{op}")(*tt)
    assert got.dtype == torch.bfloat16
    want = getattr(jref, f"ref_{op}")(*jj)
    assert _frob(_np(got), want.astype(jnp.float32)) < BF16_TOL["jnp"]
    pallas = _PALLAS[op](*jj, interpret=True)
    assert _frob(_np(got), pallas.astype(jnp.float32)) < BF16_TOL["pallas"]


@pytest.mark.parametrize("op", list(_OPS))
def test_ids_outside_the_bank_map_as_jax_gathers(op):
    """An id past the bank serves the last tenant and a negative one
    counts from the end, as the jnp gather maps them; the host guard
    (validate_tenant_ids) is what refuses such ids."""
    k = _bank_inputs(5, 4, 2, 96, 64, 4, 5)
    k["ids"] = np.array([7, -1, -9, 2], np.int32)
    tt, jj = _both(k, _OPS[op])
    got = getattr(ref, f"ref_{op}")(*tt)
    assert _max_err(got, getattr(jref, f"ref_{op}")(*jj)) < F32_TOL
    k["ids"] = np.array([4, 4, 0, 2], np.int32)
    tt, _ = _both(k, _OPS[op])
    assert torch.equal(getattr(ref, f"ref_{op}")(*tt), got)


@pytest.mark.parametrize("op", list(_OPS))
def test_cpu_bank_wrappers_take_the_plain_version_and_launch_nothing(op):
    k = _bank_inputs(6, 3, 5, 96, 70, 8, 4)
    tt, _ = _both(k, _OPS[op])
    ops.reset_launches()
    got = getattr(ops, op)(*tt)
    assert torch.equal(got, getattr(ref, f"ref_{op}")(*tt))
    assert torch.equal(getattr(ops, op)(*tt[:-1], tt[-1].long()), got)
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)


def _refusals():
    k = _bank_inputs(7, 2, 3, 96, 64, 4, 3)
    x, w, u, v = (_t(k[n]) for n in ("x", "w", "u", "v"))
    a, b, s, r, c = (_t(k[n]) for n in ("a", "b", "s", "r", "c"))
    ids = torch.from_numpy(k["ids"])
    return {
        "float ids": (lambda: ops.householder_gemm_batched(
            x, w, u, ids.float()), "int32 or int64"),
        "one id short": (lambda: ops.hyperadapt_gemm_batched(
            x, w, r, c, ids[:1]), "int32 or int64"),
        "n·db ≠ d": (lambda: ops.householder_gemm_batched(
            x, w, u[:, :3], ids), "u_bank must be"),
        "empty bank": (lambda: ops.etherplus_reflect_batched(
            x, u[:0], v[:0], ids), "u_bank must be"),
        "v apart from u": (lambda: ops.etherplus_reflect_batched(
            x, u, v[:2], ids), "v_bank must be"),
        "s in f64": (lambda: ops.delora_gemm_batched(
            x, w, a, b, s.double(), ids), "s_bank must be"),
        "b of another rank": (lambda: ops.delora_gemm_batched(
            x, w, a, b[:, :3], s, ids), "b_bank must be"),
        "c of another width": (lambda: ops.hyperadapt_gemm_batched(
            x, w, r, c[:, :5], ids), "c_bank must be"),
        "tokens without sequences": (lambda: ops.hyperadapt_gemm_batched(
            x[0], w, r, c, ids), r"\(B, S, d\)"),
        "fp16": (lambda: ops.householder_gemm_batched(
            x.half(), w.half(), u, ids), "float32 or bfloat16"),
        "strided x": (lambda: ops.hyperadapt_gemm_batched(
            x.transpose(0, 1).contiguous().transpose(0, 1), w, r, c, ids),
            "contiguous")}


@pytest.mark.parametrize("case", list(_refusals()))
def test_bank_wrappers_refuse_what_the_kernels_do_not_take(case):
    fn, match = _refusals()[case]
    with pytest.raises(ops.KernelInputError, match=match):
        fn()


def test_cuda_backend_on_cpu_raises_for_the_bank_ops():
    k = _bank_inputs(8, 2, 3, 96, 64, 4, 3)
    (x, w, u, ids), _ = _both(k, ("x", "w", "u", "ids"))
    with pytest.raises(execute.BackendError, match="only on CUDA tensors"):
        execute.dispatch("householder_gemm_batched", "cuda", x, w, u, ids)


# ---------------------------------------------------------------------------
# AdapterBank and validate_tenant_ids against repro.core.peft
# ---------------------------------------------------------------------------

def _peft_pair(arch, method):
    return (JPEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                        targets=jpeft_targets(arch), backend="jnp"),
            T.PEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                         targets=peft_targets(arch)))


# each tenant moved off its method's identity, from its own seed
_SPREAD = {("etherplus", "v1"): 0.5, ("etherplus", "v2"): 0.5,
           ("delora", "b"): 0.5, ("delora", "lam"): 2.0,
           ("hyperadapt", "r"): 0.2, ("hyperadapt", "c"): 0.2}


def _tenant_tree(params, jp, method, t):
    tree = jpeft.init_adapters(jax.random.PRNGKey(100 + t), params, jp)
    rng = np.random.default_rng(1000 + t)

    def move(path, leaf):
        sd = _SPREAD.get((method, path[-1].key))
        if sd is None:
            return leaf
        return leaf + sd * jnp.asarray(rng.standard_normal(leaf.shape),
                                       leaf.dtype)
    return jax.tree_util.tree_map_with_path(move, tree)


@functools.lru_cache(maxsize=None)
def _banks(arch, method, tenants=TENANTS):
    """The smoke model, one adapter tree per tenant and the stacked bank,
    in JAX and (bridged) in the port; cached."""
    cfg = jget_config(arch, "smoke")
    jp, tp = _peft_pair(arch, method)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    trees = [_tenant_tree(params, jp, method, t) for t in range(tenants)]
    jbank = jpeft.AdapterBank.stack(trees, params, jp)
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, params))
    ttrees = [bridge.to_torch(jax.tree_util.tree_map(np.asarray, t))
              for t in trees]
    return dict(cfg=cfg, tcfg=get_config(arch, "smoke"), jp=jp, tp=tp,
                params=params, tparams=tparams, trees=trees, ttrees=ttrees,
                jbank=jbank, tbank=peft.AdapterBank.stack(ttrees, tparams,
                                                          tp))


def _same_tree(port, jax_tree, exact=True):
    want = {p: np.asarray(v) for p, v in flatten_with_paths(
        jax.tree_util.tree_map(np.asarray, jax_tree))}
    got = dict(flatten_with_paths(port))
    assert set(got) == set(want)
    for p, v in got.items():
        assert tuple(v.shape) == want[p].shape, p
        if exact:
            np.testing.assert_array_equal(v.numpy(), want[p], err_msg=p)
        else:
            assert _max_err(v.numpy(), want[p]) < F32_TOL, p


@pytest.mark.parametrize("method", BANK_METHODS)
def test_adapter_bank_matches_jax(method):
    r = _banks("smollm-360m", method)
    jbank, tbank = r["jbank"], r["tbank"]
    assert tbank.tenants == jbank.tenants == TENANTS
    assert tbank.stack_ndims == jbank.stack_ndims
    _same_tree(tbank.tree, jbank.tree)
    assert tbank.size_bytes() == jbank.size_bytes()
    # the bridge carries a JAX bank across as it is
    bridged = bridge.bank_to_torch(jbank)
    assert bridged.stack_ndims == jbank.stack_ndims
    _same_tree(bridged.tree, jbank.tree)
    for t in (0, 3, TENANTS - 1):
        _same_tree(tbank.select(t), jbank.select(t))
    ids = _ids(B, TENANTS)
    _same_tree(tbank.request(torch.from_numpy(ids)),
               jbank.request(jnp.asarray(ids)))
    padded = tbank.with_capacity(TENANTS + 3, method=method)
    assert padded.tenants == TENANTS + 3
    _same_tree(padded.tree,
               jbank.with_capacity(TENANTS + 3, method=method).tree)
    _same_tree(tbank.with_capacity(TENANTS + 2).tree,
               jbank.with_capacity(TENANTS + 2).tree)
    assert tbank.with_capacity(TENANTS) is tbank
    with pytest.raises(ValueError, match="capacity"):
        tbank.with_capacity(TENANTS - 1)
    swapped = tbank.replace_slot(2, r["ttrees"][5])
    _same_tree(swapped.tree, jbank.replace_slot(2, r["trees"][5]).tree)
    _same_tree(tbank.tree, jbank.tree)          # the original is untouched
    _same_tree(swapped.select(2), r["trees"][5])


def test_adapter_bank_refuses_what_jax_refuses():
    r = _banks("smollm-360m", "ether")
    lora = T.PEFTConfig(method="lora", targets=peft_targets("smollm-360m"))
    with pytest.raises(ValueError, match="AdapterBank supports"):
        peft.AdapterBank.stack(r["ttrees"], r["tparams"], lora)
    with pytest.raises(ValueError, match="at least one tenant"):
        peft.AdapterBank.stack([], r["tparams"], r["tp"])
    assert peft.AdapterBank.BANK_METHODS == methods.bank_servable() == (
        "ether", "etherplus", "delora", "hyperadapt")


def test_init_adapter_bank_draws_each_tenant_from_its_own_generator():
    cfg = get_config("smollm-360m", "smoke")
    tp = T.PEFTConfig(n_blocks=8, targets=peft_targets("smollm-360m"))
    params = api.init_model(cfg, seed=0, device="cpu")
    bank = peft.init_adapter_bank(3, params, tp, 4)
    again = peft.init_adapter_bank(3, params, tp, 4)
    u = bank.tree["units"]["pos0"]["mixer"]["q_proj"]["u"]    # (L, A, n, db)
    assert u.shape[:2] == (cfg.n_layers, 4)
    assert torch.equal(u, again.tree["units"]["pos0"]["mixer"]["q_proj"]["u"])
    for t in range(1, 4):
        assert not torch.equal(u[:, t], u[:, 0])


@pytest.mark.parametrize("ids,tenants,err,match", [
    ([0, 3], 3, ValueError, r"tenant id\(s\) \[3\] out of range \[0, 3\)"),
    ([-1, 2, 5, 5], 4, ValueError, r"\[-1, 5\] out of range"),
    ([0.0, 1.0], 3, TypeError, "tenant ids must be integers"),
    (torch.tensor([0, 7]), 4, ValueError, r"\[7\] out of range")])
def test_validate_tenant_ids_raises_where_jax_does(ids, tenants, err, match):
    with pytest.raises(err, match=match):
        peft.validate_tenant_ids(ids, tenants)
    jids = np.asarray(ids)
    with pytest.raises(err, match=match):
        jpeft.validate_tenant_ids(jids, tenants)


def test_validate_tenant_ids_returns_int32_as_jax():
    for ids in ([2, 0, 2], np.array([1], np.int64), torch.tensor([3, 1]),
                []):
        got = peft.validate_tenant_ids(ids, 4)
        want = jpeft.validate_tenant_ids(np.asarray(ids), 4)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# adapted_dense's bank branch and the models against the JAX package
# ---------------------------------------------------------------------------

def _module_bank(method, d, f, a, seed):
    """One linear's bank (leaves with the tenant axis first), per method,
    each tenant off its identity."""
    k = _bank_inputs(seed, 3, 5, d, f, 8, a)
    return {"ether": {"u": k["u"]},
            "etherplus": {"u1": k["u"], "v1": k["v"], "u2": k["u2"],
                          "v2": k["v2"]},
            "delora": {"a": k["a"], "b": k["b"],
                       "lam": np.float32(2) + k["s"][:, 0]},
            "hyperadapt": {"r": k["r"], "c": k["c"]}}[method], k


@pytest.mark.parametrize("method", BANK_METHODS)
def test_adapted_dense_bank_branch_matches_jax(method):
    d, f, a = 96, 64, 5
    bank, k = _module_bank(method, d, f, a, 9)
    jp, tp = _peft_pair("smollm-360m", method)
    bias = np.random.default_rng(9).standard_normal(f).astype(np.float32)
    jad = {kk: jnp.asarray(v) for kk, v in bank.items()}
    jad["ids"] = jnp.asarray(k["ids"])
    tad = {kk: _t(v) for kk, v in bank.items()}
    tad["ids"] = torch.from_numpy(k["ids"])
    want = jT.adapted_dense(jnp.asarray(k["x"]), jnp.asarray(k["w"]),
                            jnp.asarray(bias), jad, jp)
    execute.reset_counters()
    got = T.adapted_dense(_t(k["x"]), _t(k["w"]), _t(bias), tad, tp)
    op = {"ether": "householder_gemm_batched",
          "etherplus": "etherplus_reflect_batched"}.get(
              method, f"{method}_gemm_batched")
    assert execute.counters() == {
        f"{op}.torch": 2 if method == "etherplus" else 1}
    assert _max_err(got, want) < F32_TOL
    # the bank's rows differ from the frozen linear and from each other
    plain = _t(k["x"]) @ _t(k["w"]) + _t(bias)
    assert _max_err(got, plain) > 1e-2
    assert _max_err(got[0], got[1]) > 1e-2
    with pytest.raises(ValueError, match=r"per-request \(B, S, d\)"):
        T.adapted_dense(_t(k["x"])[0], _t(k["w"]), None, tad, tp)
    with pytest.raises(ValueError, match=r"per-request \(B, S, d\)"):
        T.adapted_dense(_t(k["x"])[:2], _t(k["w"]), None, tad, tp)


def test_one_sided_etherplus_bank_matches_jax():
    """two_sided=False: only the input side's bank update, around the
    frozen product (one reflection call a linear)."""
    bank, k = _module_bank("etherplus", 96, 64, 5, 11)
    bank = {kk: bank[kk] for kk in ("u1", "v1")}
    jp, tp = _peft_pair("smollm-360m", "etherplus")
    jp = JPEFTConfig(**{**jp.__dict__, "two_sided": False})
    tp = T.PEFTConfig(**{**tp.__dict__, "two_sided": False})
    jad = {**{kk: jnp.asarray(v) for kk, v in bank.items()},
           "ids": jnp.asarray(k["ids"])}
    tad = {**{kk: _t(v) for kk, v in bank.items()},
           "ids": torch.from_numpy(k["ids"])}
    want = jT.adapted_dense(jnp.asarray(k["x"]), jnp.asarray(k["w"]), None,
                            jad, jp)
    execute.reset_counters()
    got = T.adapted_dense(_t(k["x"]), _t(k["w"]), None, tad, tp)
    assert execute.counters() == {"etherplus_reflect_batched.torch": 1}
    assert _max_err(got, want) < F32_TOL


def test_bank_dense_of_other_methods_raises_the_jax_error():
    for name in ("lora", "oft", "naive", "full"):
        with pytest.raises(ValueError, match="is not bank-servable"):
            methods.get(name).bank_dense(None, None, {}, None)


@functools.lru_cache(maxsize=None)
def _bank_serve_run(arch, method):
    """JAX and port prefill + decode of one batch through the bank, on the
    same weights and tenants; cached."""
    r = _banks(arch, method)
    cfg, tcfg, jp, tp = r["cfg"], r["tcfg"], r["jp"], r["tp"]
    ids = _ids(B, TENANTS)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, P)).astype(
        np.int32)
    jids = jnp.asarray(ids)
    jcache, jlog = japi.prefill(r["params"], r["jbank"],
                                {"tokens": jnp.asarray(tokens)}, cfg, jp,
                                tenant_ids=jids)
    c = japi.pad_cache(jcache, cfg, P + GEN + 1)
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    jtoks, jsteps = [np.asarray(tok)], []
    for _ in range(GEN):
        lg, c = japi.decode_step(r["params"], r["jbank"], c, tok, cfg, jp,
                                 tenant_ids=jids)
        jsteps.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        jtoks.append(np.asarray(tok))

    tids = torch.from_numpy(ids)
    ttok = torch.from_numpy(tokens).long()
    execute.reset_counters()
    tcache, tlog = api.prefill(r["tparams"], r["tbank"], {"tokens": ttok},
                               tcfg, tp, tenant_ids=tids)
    calls = execute.counters()
    c = api.pad_cache(tcache, tcfg, P + GEN + 1)
    tsteps = []
    for i in range(GEN):                # decode on JAX's greedy tokens
        lg, c = api.decode_step(r["tparams"], r["tbank"], c,
                                torch.from_numpy(np.array(jtoks[i])).long(),
                                tcfg, tp, tenant_ids=tids)
        tsteps.append(lg.numpy())
    return dict(jlog=jlog, jsteps=jsteps, tlog=tlog, tsteps=tsteps,
                calls=calls, n_layers=tcfg.n_layers)


@pytest.mark.parametrize("method", BANK_METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_bank_prefill_and_decode_match_jax(arch, method):
    r = _bank_serve_run(arch, method)
    op = {"ether": "householder_gemm_batched",
          "etherplus": "etherplus_reflect_batched"}.get(
              method, f"{method}_gemm_batched")
    per_pass = 7 * r["n_layers"] * (2 if method == "etherplus" else 1)
    assert r["calls"] == {f"{op}.torch": per_pass,
                          "flash_attention.torch": r["n_layers"]}
    assert _max_err(r["tlog"], r["jlog"]) < MODEL_TOL
    for t_lg, j_lg in zip(r["tsteps"], r["jsteps"]):
        assert _max_err(t_lg, j_lg) < MODEL_TOL


@pytest.mark.parametrize("method", BANK_METHODS)
def test_each_bank_row_is_single_tenant_serving_of_its_tenant(method):
    """One prompt for every row: rows of one tenant agree, rows of two
    tenants differ, and each row equals the prompt served alone with its
    tenant's own tree (``bank.select``), prefill and a decode step."""
    r = _banks("smollm-360m", method)
    tcfg, tp, bank = r["tcfg"], r["tp"], r["tbank"]
    ids = _ids(B, TENANTS)                          # [5, 1, 5, 0]
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, (1, P))).long()
    cache, logits = api.prefill(r["tparams"], bank,
                                {"tokens": prompt.expand(B, P)}, tcfg, tp,
                                tenant_ids=torch.from_numpy(ids))
    cache = api.pad_cache(cache, tcfg, P + 2)
    nxt = torch.full((B, 1), 7, dtype=torch.long)
    step, _ = api.decode_step(r["tparams"], bank, cache, nxt, tcfg, tp,
                              tenant_ids=torch.from_numpy(ids))
    for row, t in enumerate(ids.tolist()):
        c1, alone = api.prefill(r["tparams"], bank.select(t),
                                {"tokens": prompt}, tcfg, tp)
        c1 = api.pad_cache(c1, tcfg, P + 2)
        alone_step, _ = api.decode_step(r["tparams"], bank.select(t), c1,
                                        nxt[:1], tcfg, tp)
        assert _max_err(logits[row], alone[0]) < MODEL_TOL
        assert _max_err(step[row], alone_step[0]) < MODEL_TOL
    assert _max_err(logits[0], logits[2]) < MODEL_TOL     # tenant 5 twice
    for i, j in ((0, 1), (0, 3), (1, 3)):                 # 5, 1, 0 apart
        assert _max_err(logits[i], logits[j]) > 1e-3


@pytest.mark.parametrize("method", BANK_METHODS)
def test_identity_rows_of_with_capacity_serve_the_base_model(method):
    """A bank padded with its method's identity rows (HyperAdapt's ones,
    zeros for the rest) serves those rows as the frozen model."""
    r = _banks("smollm-360m", method)
    tcfg, tp = r["tcfg"], r["tp"]
    bank = r["tbank"].with_capacity(TENANTS + 2, method=method)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (2, P))).long()
    _, got = api.prefill(r["tparams"], bank, {"tokens": tokens}, tcfg, tp,
                         tenant_ids=torch.tensor([TENANTS + 1, TENANTS]))
    _, base = api.prefill(r["tparams"], None, {"tokens": tokens}, tcfg, None)
    assert _max_err(got, base) < MODEL_TOL


def test_prefill_refuses_a_bank_without_ids_and_ids_without_a_bank():
    r = _banks("smollm-360m", "ether")
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="requires tenant_ids"):
        api.prefill(r["tparams"], r["tbank"], batch, r["tcfg"], r["tp"])
    with pytest.raises(ValueError, match="only applies to AdapterBank"):
        api.prefill(r["tparams"], r["tbank"].select(0), batch, r["tcfg"],
                    r["tp"], tenant_ids=[0, 1])


# ---------------------------------------------------------------------------
# serve --tenants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", BANK_METHODS)
def test_serve_cli_tenants_runs_on_cpu(method, capsys):
    res = serve.main(["--device", "cpu", "--variant", "smoke", "--tenants",
                      "4", "--method", method, "--gen", "2", "--batch", "3",
                      "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert f"adapter bank [{method}]: 4 tenants" in out
    assert "request tenant ids:" in out and "unmerged-bank overhead" in out
    op = {"ether": "householder_gemm_batched",
          "etherplus": "etherplus_reflect_batched"}.get(
              method, f"{method}_gemm_batched")
    per_forward = 7 * 4 * (2 if method == "etherplus" else 1)
    bank, merged = res["bank"], res["merged"]
    assert bank["counters"] == {f"{op}.torch": per_forward * bank["forwards"],
                                "flash_attention.torch": 4 * bank["forwards"]}
    merge_op = f"{method}_merge"
    assert merged["counters"] == {f"{merge_op}.torch": 7 * 4,
                                  "flash_attention.torch":
                                  4 * merged["forwards"]}
    assert bank["tokens"].shape == merged["tokens"].shape == (3, 3)
    assert torch.isfinite(bank["logits"]).all()
    ids = res["tenant_ids"]
    assert ids.dtype == torch.int32 and ((ids >= 0) & (ids < 4)).all()
    assert res["bank_bytes"] > 0


@pytest.mark.parametrize("argv,match", [
    (["--method", "lora"], "requires a bank-servable --method"),
    (["--merged"], "--merged conflicts with --tenants")])
def test_serve_cli_tenants_refuses_as_jax_does(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--device", "cpu", "--tenants", "4", *argv])
