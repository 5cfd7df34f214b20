"""Training through a multi-tenant adapter bank, the port held against the
JAX package on the CPU.

Per op: the plain versions of the three bank backward kernels
(``householder_gemm_batched_bwd``, ``householder_gemm_batched_dw``,
``etherplus_reflect_batched_bwd``: dx, the per-sequence ĝ, dW) against
the interpret-mode Pallas kernels; the checked wrappers (dx, dW and the
banks' gradients, DeLoRA's and HyperAdapt's cotangents) against the JAX
package's ``ops.*_batched_bwd``; and ``adapted_dense``'s bank branch
under autograd against ``jax.grad`` of the JAX one.  Model level, on the
smollm-360m and Llama-2-7B smoke configs: the gradient of
``train_loss(params, bank.request(ids), ...)`` over ``bank.tree`` against
``jax.value_and_grad`` of the same loss, for ETHER, ETHER+, DeLoRA (from b
≠ 0) and HyperAdapt, and a 3-step AdamW trajectory for ETHER and ETHER+.

Every tenant comes from its own seed, off its method's identity; the ids
hold a tenant twice, the last tenant A − 1 and, where the JAX reference
maps it as the port does, a negative id; the shapes have odd S and
widths that no tile divides.  One test shows an id ≥ A, where the JAX
package's gradient drops the sequence its forward served (ROADMAP.md,
Queue 3) and the port's lands on the tenant that served it."""

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
from repro.kernels.gemm_bwd import (householder_gemm_batched_bwd_pallas,
                                    householder_gemm_batched_dw_pallas)
from repro.kernels.reflect_bwd_batched import \
    etherplus_reflect_batched_bwd_pallas
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply_updates
from repro.optim import schedules as jsched
from repro_torch import bridge
from repro_torch.common.pytree import flatten_with_paths, map_with_paths
from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute, peft
from repro_torch.core import transforms as T
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import adamw, schedules

ARCHS = ["smollm-360m", "llama-2-7b"]
BANK_METHODS = ["ether", "etherplus", "delora", "hyperadapt"]
# (B, S, d, f, n, A): an odd S with a d that no 128-tile divides (db 15,
# f 70), decode (S = 1), and a longer odd S past one 32-row tile
SHAPES = [(3, 17, 120, 70, 8, 5), (4, 1, 96, 128, 8, 6),
          (3, 37, 96, 40, 4, 4)]
# float32, normalised max error max|a − b| / max|b|: the same f32 math in
# another sum order
F32_TOL = 1e-5
# bf16, relative Frobenius: the Pallas kernels and the port compute in f32
# and round dx once
BF16_TOL = 1e-3
# the smoke models' loss and bank gradients: f32 sums in another order
# through their layers (test_torch_train.py holds the single-tenant
# gradients to the same 1e-4)
GRAD_TOL = 1e-4
B, S, TENANTS, STEPS = 3, 16, 5, 3
# the ids of the model-level runs: tenant 4 twice, tenant 0; 1-3 untouched
MODEL_IDS = [4, 0, 4]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _max_err(a, b):
    a, b = _f32(a), _f32(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _frob(a, b):
    a, b = _f32(a), _f32(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _ids(b, a, negative=False):
    """Unsorted, the last tenant A − 1 twice, tenant 1 (or −1, which maps
    to A − 1 as well), tenant 0."""
    return np.array([a - 1, -1 if negative else 1, a - 1, 0][:b], np.int32)


def _operands(seed, b, s, d, f, n, a, r=5):
    """x, the cotangents and every method's bank, each tenant off its
    identity (v apart from u, b ≠ 0, r and c about 1)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"x": draw(b, s, d), "w": draw(d, f) / np.float32(np.sqrt(d)),
            "g": draw(b, s, f), "gd": draw(b, s, d),
            "u": draw(a, n, d // n), "v": draw(a, n, d // n),
            "a": draw(a, d, r), "b": draw(a, r, f),
            "s": np.abs(draw(a, r)) + np.float32(0.1),
            "r": 1 + 0.3 * draw(a, d), "c": 1 + 0.3 * draw(a, f)}


def _act(k, names, dtype):
    """The named operands as torch tensors: activations (x, w, g, gd and
    DeLoRA's s) in ``dtype``, banks float32, ids int32."""
    act = ("x", "w", "g", "gd", "s")
    return [torch.from_numpy(k[nm]) if nm == "ids" else
            _t(k[nm], dtype if nm in act else torch.float32) for nm in names]


def _jnp(k, names, dtype=jnp.float32):
    act = ("x", "w", "g", "gd", "s")
    return [jnp.asarray(k[nm]) if nm == "ids" else
            jnp.asarray(k[nm], dtype if nm in act else jnp.float32)
            for nm in names]


# ---------------------------------------------------------------------------
# Per op: the plain versions against the interpret-mode Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d,f,n,a", SHAPES)
def test_householder_gemm_batched_bwd_matches_pallas(b, s, d, f, n, a):
    k = dict(_operands(1, b, s, d, f, n, a), ids=_ids(b, a))
    dx, gh = ref.ref_householder_gemm_batched_bwd(
        *_act(k, ("x", "w", "u", "ids", "g"), torch.float32))
    jdx, jgh = householder_gemm_batched_bwd_pallas(
        *_jnp(k, ("x", "w", "u", "ids", "g")), interpret=True)
    assert gh.shape == (b, n, d // n) and gh.dtype == torch.float32
    assert _max_err(dx, jdx) < F32_TOL
    assert _max_err(gh, jgh) < F32_TOL
    dw = ref.ref_householder_gemm_batched_dw(
        *_act(k, ("x", "u", "ids", "g"), torch.float32), torch.float32)
    jdw = householder_gemm_batched_dw_pallas(
        *_jnp(k, ("x", "u", "ids", "g")), interpret=True)
    assert _max_err(dw, jdw) < F32_TOL


@pytest.mark.parametrize("b,s,d,f,n,a", SHAPES)
def test_etherplus_reflect_batched_bwd_matches_pallas(b, s, d, f, n, a):
    k = dict(_operands(2, b, s, d, f, n, a), ids=_ids(b, a))
    got = ref.ref_etherplus_reflect_batched_bwd(
        *_act(k, ("x", "u", "v", "ids", "gd"), torch.float32))
    want = etherplus_reflect_batched_bwd_pallas(
        *_jnp(k, ("x", "u", "v", "ids", "gd")), interpret=True)
    for p, q in zip(got, want):
        assert _max_err(p, q) < F32_TOL


def test_bf16_bank_backwards_match_pallas():
    b, s, d, f, n, a = SHAPES[0]
    k = dict(_operands(3, b, s, d, f, n, a), ids=_ids(b, a))
    bf = jnp.bfloat16
    dx, gh = ref.ref_householder_gemm_batched_bwd(
        *_act(k, ("x", "w", "u", "ids", "g"), torch.bfloat16))
    jdx, jgh = householder_gemm_batched_bwd_pallas(
        *_jnp(k, ("x", "w", "u", "ids", "g"), bf), interpret=True)
    assert dx.dtype == torch.bfloat16
    assert _frob(dx, jdx) < BF16_TOL and _frob(gh, jgh) < BF16_TOL
    dw = ref.ref_householder_gemm_batched_dw(
        *_act(k, ("x", "u", "ids", "g"), torch.bfloat16), torch.bfloat16)
    jdw = householder_gemm_batched_dw_pallas(
        *_jnp(k, ("x", "u", "ids", "g"), bf), interpret=True)
    assert _frob(dw, jdw) < BF16_TOL
    got = ref.ref_etherplus_reflect_batched_bwd(
        *_act(k, ("x", "u", "v", "ids", "gd"), torch.bfloat16))
    want = etherplus_reflect_batched_bwd_pallas(
        *_jnp(k, ("x", "u", "v", "ids", "gd"), bf), interpret=True)
    for p, q in zip(got, want):
        assert _frob(p, q) < BF16_TOL


# ---------------------------------------------------------------------------
# Per op: the wrappers against the JAX package's ops.*_batched_bwd
# ---------------------------------------------------------------------------

def _port_and_jax_bwd(method, k, need_dw=True):
    """The port's wrapper (CPU: its plain version) and the JAX op on the
    same operands: (port outputs, JAX outputs) without the ids' float0."""
    if method == "ether":
        got = ops.householder_gemm_batched_bwd(
            *_act(k, ("x", "w", "u", "ids", "g"), torch.float32),
            need_dw=need_dw)
        want = jops.householder_gemm_batched_bwd(
            *_jnp(k, ("x", "w", "u", "ids", "g")), interpret=True)
    elif method == "etherplus":
        got = ops.etherplus_reflect_batched_bwd(
            *_act(k, ("x", "u", "v", "ids", "gd"), torch.float32))
        want = jops.etherplus_reflect_batched_bwd(
            *_jnp(k, ("x", "u", "v", "ids", "gd")), interpret=True)
    elif method == "delora":
        got = ops.delora_gemm_batched_bwd(
            *_act(k, ("x", "w", "a", "b", "s", "ids", "g"), torch.float32),
            need_dw=need_dw)
        want = jops.delora_gemm_batched_bwd(
            *_jnp(k, ("x", "w", "a", "b", "s", "ids", "g")), interpret=True)
    else:
        got = ops.hyperadapt_gemm_batched_bwd(
            *_act(k, ("x", "w", "r", "c", "ids", "g"), torch.float32),
            need_dw=need_dw)
        want = jops.hyperadapt_gemm_batched_bwd(
            *_jnp(k, ("x", "w", "r", "c", "ids", "g")), interpret=True)
    return got, want[:len(got)]


@pytest.mark.parametrize("method", BANK_METHODS)
@pytest.mark.parametrize("b,s,d,f,n,a", SHAPES)
def test_bank_backward_wrappers_match_jax_ops(method, b, s, d, f, n, a):
    k = dict(_operands(4, b, s, d, f, n, a), ids=_ids(b, a))
    ops.reset_launches()
    got, want = _port_and_jax_bwd(method, k)
    assert not any(ops.launches().values())        # CPU: the plain version
    for i, (p, q) in enumerate(zip(got, want)):
        assert tuple(p.shape) == q.shape, (method, i)
        assert _max_err(p, q) < F32_TOL, (method, i)
    # the tenants no id names get exact zeros, the named ones do not
    bank_grads = got[2:] if method in ("ether", "delora", "hyperadapt") \
        else got[1:]
    named = sorted({int(i) % a for i in k["ids"]})
    for gr in bank_grads:
        for t in range(a):
            rows = gr[t].abs().max().item()
            assert (rows > 0) if t in named else (rows == 0), (method, t)


@pytest.mark.parametrize("method", ["ether", "delora", "hyperadapt"])
def test_bank_backward_wrappers_skip_dw_unless_asked(method):
    k = dict(_operands(5, *SHAPES[0]), ids=_ids(3, SHAPES[0][-1]))
    got, _ = _port_and_jax_bwd(method, k, need_dw=False)
    full, _ = _port_and_jax_bwd(method, k, need_dw=True)
    assert got[1] is None and full[1] is not None
    for p, q in zip(got, full):
        if p is not None:
            torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_bank_grad_adds_duplicate_ids_and_zeroes_untouched_tenants():
    rng = np.random.default_rng(6)
    bank = _t(rng.standard_normal((5, 4, 6)))
    gh = _t(rng.standard_normal((4, 4, 6)))
    ids = torch.tensor([3, 1, 3, -1], dtype=torch.int32)     # -1 → 4
    got = ref.bank_grad(bank, ids, gh)
    want = jops._bank_grad(jnp.asarray(_np(bank)),
                           jnp.asarray(ids.numpy()), jnp.asarray(_np(gh)))
    assert _max_err(got, want) < F32_TOL
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(
        got[3], ref.norm_chain(bank[3], gh[0] + gh[2]), rtol=1e-6, atol=0)


def test_ids_beyond_the_bank_train_the_tenant_that_served_them():
    """An id ≥ A: both packages' forwards serve tenant A − 1 (the gather
    clamps); the JAX package's backward drops that sequence from the bank
    (``.at[ids].add`` drops an index past the end,
    src/repro/kernels/ops.py:283), so its gradient is not the gradient of
    its own forward.  The port's backward maps the id as its forward does,
    so tenant A − 1 gets the sequence's gradient."""
    b, s, d, f, n, a = SHAPES[0]
    k = _operands(7, b, s, d, f, n, a)
    far = dict(k, ids=np.array([a + 2, 0, 1], np.int32))
    last = dict(k, ids=np.array([a - 1, 0, 1], np.int32))
    jfar, jlast = (jops.householder_gemm_batched_bwd(
        *_jnp(kk, ("x", "w", "u", "ids", "g")), interpret=True)[2]
        for kk in (far, last))
    tfar, tlast = (ops.householder_gemm_batched_bwd(
        *_act(kk, ("x", "w", "u", "ids", "g"), torch.float32),
        need_dw=False)[2] for kk in (far, last))
    # the forwards agree: id a + 2 is served by tenant a − 1
    y_far = ops.householder_gemm_batched(
        *_act(far, ("x", "w", "u", "ids"), torch.float32))
    y_last = ops.householder_gemm_batched(
        *_act(last, ("x", "w", "u", "ids"), torch.float32))
    torch.testing.assert_close(y_far, y_last, rtol=0, atol=0)
    # JAX: tenant a − 1 gets nothing; the port: what it gets for id a − 1
    assert float(jnp.abs(jfar[a - 1]).max()) == 0.0
    assert float(jnp.abs(jlast[a - 1]).max()) > 0.0
    torch.testing.assert_close(tfar, tlast, rtol=0, atol=0)
    assert _max_err(tlast, jlast) < F32_TOL
    # the tenants in [0, A) agree in both packages
    assert _max_err(tfar[:a - 1], jfar[:a - 1]) < F32_TOL


@pytest.mark.parametrize("op", ["householder_gemm_batched_bwd",
                                "etherplus_reflect_batched_bwd",
                                "delora_gemm_batched_bwd",
                                "hyperadapt_gemm_batched_bwd"])
def test_bank_backward_wrappers_refuse_a_wrong_cotangent(op):
    k = dict(_operands(8, *SHAPES[0]), ids=_ids(3, SHAPES[0][-1]))
    names = {"householder_gemm_batched_bwd": ("x", "w", "u", "ids", "g"),
             "etherplus_reflect_batched_bwd": ("x", "u", "v", "ids", "gd"),
             "delora_gemm_batched_bwd": ("x", "w", "a", "b", "s", "ids", "g"),
             "hyperadapt_gemm_batched_bwd": ("x", "w", "r", "c", "ids", "g")
             }[op]
    args = _act(k, names, torch.float32)
    kw = {} if op == "etherplus_reflect_batched_bwd" else {"need_dw": False}
    bad = list(args)
    bad[-1] = args[-1][:, :-1]                      # one row short
    with pytest.raises(ops.KernelInputError, match="g must be"):
        getattr(ops, op)(*bad, **kw)
    bad[-1] = args[-1].to(torch.bfloat16)
    with pytest.raises(ops.KernelInputError, match="g must be"):
        getattr(ops, op)(*bad, **kw)


# ---------------------------------------------------------------------------
# adapted_dense's bank branch under autograd against jax.grad
# ---------------------------------------------------------------------------

def _module_bank(method, k):
    return {"ether": {"u": k["u"]},
            "etherplus": {"u1": k["u"], "v1": k["v"], "u2": k["u2"],
                          "v2": k["v2"]},
            "delora": {"a": k["a"], "b": k["b"], "lam": k["lam"]},
            "hyperadapt": {"r": k["r"], "c": k["c"]}}[method]


@pytest.mark.parametrize("method", BANK_METHODS)
def test_adapted_dense_bank_gradients_match_jax(method):
    """x, W and every bank leaf through the bank forward under autograd
    (W trains here, so the dW kernels' plain versions run too), with a
    negative id, against jax.grad of the JAX package's bank branch."""
    b, s, d, f, n, a = SHAPES[0]
    rng = np.random.default_rng(9)
    k = dict(_operands(9, b, s, d, f, n, a), ids=_ids(b, a, negative=True))
    n_out = T.resolve_blocks(8, f)
    k.update(u2=rng.standard_normal((a, n_out, f // n_out)).astype(np.float32),
             v2=rng.standard_normal((a, n_out, f // n_out)).astype(np.float32),
             lam=(2 + rng.standard_normal(a)).astype(np.float32))
    bank = _module_bank(method, k)
    jp = JPEFTConfig(method=method, n_blocks=n, rank=5, alpha=5.0,
                     backend="jnp")
    tp = T.PEFTConfig(method=method, n_blocks=n, rank=5, alpha=5.0)
    ids = jnp.asarray(k["ids"])

    def jloss(x, w, tree):
        y = jT.adapted_dense(x, w, None, {**tree, "ids": ids}, jp)
        return jnp.sum(y * jnp.asarray(k["g"]))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(k["x"]), jnp.asarray(k["w"]),
        {kk: jnp.asarray(v) for kk, v in bank.items()})

    x, w = _t(k["x"]).requires_grad_(), _t(k["w"]).requires_grad_()
    tree = {kk: _t(v).requires_grad_() for kk, v in bank.items()}
    execute.reset_counters()
    y = T.adapted_dense(x, w, None, {**tree, "ids": torch.from_numpy(
        k["ids"])}, tp)
    (y * _t(k["g"])).sum().backward()
    op = {"ether": "householder_gemm_batched",
          "etherplus": "etherplus_reflect_batched"}.get(
              method, f"{method}_gemm_batched")
    calls = 2 if method == "etherplus" else 1
    assert execute.counters() == {f"{op}.torch": calls,
                                  f"{op}_bwd.torch": calls}
    assert _max_err(x.grad, jg[0]) < F32_TOL
    assert _max_err(w.grad, jg[1]) < F32_TOL
    for kk, leaf in tree.items():
        assert _max_err(leaf.grad, jg[2][kk]) < F32_TOL, kk
        # tenants 1 and 2 serve no sequence (ids [4, -1, 4] map to 4, 4, 4)
        assert torch.equal(leaf.grad[1:4], torch.zeros_like(leaf.grad[1:4]))


# ---------------------------------------------------------------------------
# Model level: train_loss through bank.request(ids), and a trajectory
# ---------------------------------------------------------------------------

# each tenant's every leaf moved by spread·N(0, 1) from one init, from its
# own seed: 1 where no entry says otherwise; ETHER+'s v apart from u (the
# init's v = u is H⁺ = I); DeLoRA from b ≠ 0 (at b = 0 the JAX package's
# gradient is NaN, ROADMAP Queue 3); HyperAdapt's r and c about 1
_SPREAD = {("etherplus", "v1"): 0.5, ("etherplus", "v2"): 0.5,
           ("delora", "b"): 0.5, ("delora", "lam"): 2.0,
           ("hyperadapt", "r"): 0.2, ("hyperadapt", "c"): 0.2}


def _peft_pair(arch, method):
    return (JPEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                        targets=jpeft_targets(arch), backend="jnp"),
            T.PEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                         targets=peft_targets(arch)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _params(arch):
    params = japi.init_model(jax.random.PRNGKey(0), jget_config(arch, "smoke"))
    return params, bridge.to_torch(_np_tree(params))


@functools.lru_cache(maxsize=None)
def _model(arch, method):
    """The smoke model, a bank of TENANTS tenants, each off its method's
    identity, in JAX and (bridged) in the port, and the jitted JAX loss
    and gradient over the bank's tree at MODEL_IDS."""
    cfg = jget_config(arch, "smoke")
    jp, tp = _peft_pair(arch, method)
    params, tparams = _params(arch)
    # one adapter tree's layout (the port's init has the JAX package's
    # paths and shapes), each tenant drawn about it in numpy
    init = map_with_paths(lambda _, t: t.numpy(), peft.init_adapters(
        torch.Generator().manual_seed(100), tparams, tp))
    trees = []
    for t in range(TENANTS):
        rng = np.random.default_rng(1000 + t)

        def move(path, leaf):
            sd = _SPREAD.get((method, path[-1].key), 1.0)
            return jnp.asarray(leaf + sd * rng.standard_normal(
                leaf.shape).astype(leaf.dtype))
        trees.append(jax.tree_util.tree_map_with_path(move, init))
    jbank = jpeft.AdapterBank.stack(trees, params, jp)
    ids = jnp.asarray(MODEL_IDS, jnp.int32)

    def loss(tree, batch):
        req = jpeft.AdapterBank(tree, jbank.tenants,
                                jbank.stack_ndims).request(ids)
        return japi.train_loss(params, req, batch, cfg, jp)
    return dict(cfg=cfg, tcfg=get_config(arch, "smoke"), jp=jp, tp=tp,
                jbank=jbank, tparams=tparams, jgrad=jax.jit(
                    jax.value_and_grad(loss, has_aux=True)))


def _batch(step):
    return JStream(vocab=jget_config("smollm-360m", "smoke").vocab, batch=B,
                   seq_len=S, seed=0).batch_at(step)


@pytest.mark.parametrize("method", BANK_METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_bank_train_loss_and_grads_match_jax(arch, method):
    m = _model(arch, method)
    batch = _batch(0)
    (jloss, _), jgrads = m["jgrad"](
        m["jbank"].tree, {kk: jnp.asarray(v) for kk, v in batch.items()})

    tbank = bridge.bank_to_torch(m["jbank"])
    leaves = flatten_with_paths(tbank.tree)
    for _, leaf in leaves:
        leaf.requires_grad_()
    execute.reset_counters()
    tloss, _ = api.train_loss(m["tparams"], tbank.request(MODEL_IDS),
                              {kk: torch.from_numpy(v).long()
                               for kk, v in batch.items()},
                              m["tcfg"], m["tp"])
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) / float(jloss) < F32_TOL
    op = {"ether": "householder_gemm_batched",
          "etherplus": "etherplus_reflect_batched"}.get(
              method, f"{method}_gemm_batched")
    per_pass = 7 * m["tcfg"].n_layers * (2 if method == "etherplus" else 1)
    # the attention of each layer on its plain route under autograd (the
    # smoke config does not rematerialise)
    assert execute.counters() == {f"{op}.torch": per_pass,
                                  f"{op}_bwd.torch": per_pass,
                                  "flash_attention.torch":
                                      m["tcfg"].n_layers}
    jg = dict(jflatten(jgrads))
    for path, leaf in leaves:
        assert np.isfinite(jg[path]).all(), path
        assert _max_err(_np(leaf.grad), jg[path]) < GRAD_TOL, path
        # tenants 1-3 serve no sequence: their rows are exactly zero
        nd = tbank.stack_ndims[path.rsplit("/", 1)[0]]
        untouched = leaf.grad.narrow(nd, 1, 3)
        assert torch.equal(untouched, torch.zeros_like(untouched)), path


@functools.lru_cache(maxsize=None)
def _bank_trajectories(method):
    """STEPS AdamW/cosine steps through the bank in both packages, from
    the same bank; the port's step is ``steps.make_bank_train_step``."""
    m = _model("smollm-360m", method)
    jopt = jadamw(jsched.cosine(2e-3, STEPS, 1))
    topt = adamw(schedules.cosine(2e-3, STEPS, 1))
    jtree = m["jbank"].tree
    jopt_state = jopt.init(jtree)
    tbank = bridge.bank_to_torch(m["jbank"])
    tstate = steps.make_bank_state(m["tparams"], tbank, topt)
    tstep = steps.make_bank_train_step(m["tcfg"], m["tp"], topt, tbank)
    jl, tl = [], []
    for i in range(STEPS):
        jb = _batch(i)
        (loss, _), g = m["jgrad"](jtree, {kk: jnp.asarray(v)
                                          for kk, v in jb.items()})
        upd, jopt_state = jopt.update(g, jopt_state, jtree)
        jtree = japply_updates(jtree, upd)
        tstate, tm = tstep(tstate, {kk: torch.from_numpy(v).long()
                                    for kk, v in jb.items()},
                           torch.tensor(MODEL_IDS, dtype=torch.int32))
        jl.append(float(loss))
        tl.append(float(tm["loss"]))
    return dict(init=dict(jflatten(_np_tree(m["jbank"].tree))),
                jfinal=dict(jflatten(_np_tree(jtree))), tstate=tstate,
                jl=np.array(jl), tl=np.array(tl))


@pytest.mark.parametrize("method", ["ether", "etherplus"])
def test_bank_adamw_trajectory_matches_jax(method):
    r = _bank_trajectories(method)
    assert np.abs(r["tl"] - r["jl"]).max() / np.abs(r["jl"]).max() < GRAD_TOL
    assert int(r["tstate"]["step"]) == STEPS
    # the bank's total update (final − initial), relative Frobenius: Adam's
    # first steps are sign-like, so an element whose gradient is at
    # rounding level may move either way on either side
    for path, leaf in flatten_with_paths(r["tstate"]["bank"]):
        want = r["jfinal"][path] - r["init"][path]
        got = _np(leaf) - r["init"][path]
        assert np.abs(want).max() > 0, path
        assert _frob(got, want) < GRAD_TOL, path
