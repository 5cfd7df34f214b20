"""The registry's standalone reflections and a differentiable ``dispatch``,
the port held against the JAX package on the CPU.

Per op: the plain versions ``ref_ether_reflect``,
``ref_ether_reflect_batched``, ``ref_ether_reflect_bwd`` and
``ref_ether_reflect_batched_bwd`` against the interpret-mode Pallas
kernels (the bank backward's per-sequence ĝ finished by the JAX op's
``_bank_grad``) and against ``repro.kernels.ref`` (whose jnp path rounds û
to the activation dtype first: ROADMAP.md, Queue 3's known differences),
at an odd T (13) and widths that no tile divides (d = 96, n ∈ {3, 8}).
Then ``execute.dispatch`` under autograd: the two reflections on the
``torch`` backend against ``jax.grad`` through the JAX package's
``dispatch(op, "pallas")``, and all fourteen forward ops against plain
autograd of their plain forwards, each counting its ``<op>_bwd`` once; a
bank's gradient with a repeated id, the last tenant A − 1 and tenants no
id names (exact zero rows); each method's ``ops`` against the JAX
registry's.  Inputs are numpy draws from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import execute as jexecute
from repro.core import methods as jmethods
from repro.core import transforms as jT
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ether_reflect import ether_reflect_pallas
from repro.kernels.ether_reflect_batched import ether_reflect_batched_pallas
from repro.kernels.reflect_bwd import ether_reflect_bwd_pallas
from repro.kernels.reflect_bwd_batched import ether_reflect_batched_bwd_pallas
from repro_torch.core import execute, methods
from repro_torch.core import transforms as T
from repro_torch.kernels import ops, ref
from repro_torch.models.ssm import ssd_chunked

T_ROWS, D = 13, 96
BLOCKS = [3, 8]
# (B, S, A): an odd S; ids name tenant A − 1 twice, tenants 1 and 0, so
# tenants 2 and 3 serve no sequence
B, S, A = 4, 13, 5
IDS = np.array([A - 1, 1, A - 1, 0], np.int32)
DTYPES = [torch.float32, torch.bfloat16]
# float32, normalised max error max|a − b| / max|b|: the same f32 math in
# another sum order
F32_TOL = 1e-5
# bf16 dx, relative Frobenius: the Pallas kernels and the port compute in
# f32 and round once, so they part by a rounding flip here and there
BF16_TOL = 1e-3
# bf16 against the jnp path, which rounds û to bf16 before the projection
# (the port and the Pallas kernels keep it in f32): relative Frobenius
JNP_BF16_TOL = 2e-2
# dispatch's gradients against plain autograd of the plain forwards: the
# Functions' explicit backwards, the same f32 math in another order
GRAD_TOL = 1e-4


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


def _held(a, b, dtype):
    """dx-like outputs: f32 by normalised max error, bf16 by relative
    Frobenius."""
    if dtype == torch.float32:
        return _max_err(a, b) <= F32_TOL
    return _frob(a, b) <= BF16_TOL


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """(torch, jax) of one numpy draw in ``dtype`` (u stays float32)."""
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(_f32(t), jnp.bfloat16 if dtype == torch.bfloat16
                          else jnp.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", BLOCKS)
def test_ether_reflect_plain_matches_pallas_and_jnp(n, dtype):
    x, u = _draw(n, (T_ROWS, D), (n, D // n))
    tx, jx = _pair(x, dtype)
    out = ref.ref_ether_reflect(tx, torch.from_numpy(u))
    assert out.dtype == dtype and out.shape == (T_ROWS, D)
    pallas = ether_reflect_pallas(jx, jnp.asarray(u))
    jnp_path = jref.ref_ether_reflect(jx, jnp.asarray(u))
    assert _held(out, pallas, dtype)
    if dtype == torch.float32:
        assert _max_err(out, jnp_path) <= F32_TOL
    else:
        assert _frob(out, jnp_path) <= JNP_BF16_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", BLOCKS)
def test_ether_reflect_bwd_plain_matches_pallas_and_ref_ad(n, dtype):
    x, u, g = _draw(10 + n, (T_ROWS, D), (n, D // n), (T_ROWS, D))
    (tx, jx), (tg, jg) = _pair(x, dtype), _pair(g, dtype)
    dx, du = ref.ref_ether_reflect_bwd(tx, torch.from_numpy(u), tg)
    assert dx.dtype == dtype and du.dtype == torch.float32
    pdx, pdu = ether_reflect_bwd_pallas(jx, jnp.asarray(u), jg)
    assert _held(dx, pdx, dtype)
    # du is float32 from the same bf16 x and g on both sides
    assert _max_err(du, pdu) <= F32_TOL
    if dtype == torch.float32:
        adx, adu = jref.ref_ether_reflect_bwd(jx, jnp.asarray(u), jg)
        assert _max_err(dx, adx) <= F32_TOL and _max_err(du, adu) <= F32_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", BLOCKS)
def test_ether_reflect_batched_plain_matches_pallas_and_jnp(n, dtype):
    x, ub = _draw(20 + n, (B, S, D), (A, n, D // n))
    tx, jx = _pair(x, dtype)
    tids = torch.from_numpy(IDS)
    out = ref.ref_ether_reflect_batched(tx, torch.from_numpy(ub), tids)
    assert out.dtype == dtype and out.shape == (B, S, D)
    pallas = ether_reflect_batched_pallas(jx, jnp.asarray(ub),
                                          jnp.asarray(IDS))
    jnp_path = jref.ref_ether_reflect_batched(jx, jnp.asarray(ub),
                                              jnp.asarray(IDS))
    assert _held(out, pallas, dtype)
    if dtype == torch.float32:
        assert _max_err(out, jnp_path) <= F32_TOL
    else:
        assert _frob(out, jnp_path) <= JNP_BF16_TOL
    # each row is its tenant's single-tenant reflection
    for b, t in enumerate(IDS):
        np.testing.assert_array_equal(_f32(out[b]), _f32(ref.ref_ether_reflect(
            tx[b], torch.from_numpy(ub[t]))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", BLOCKS)
def test_ether_reflect_batched_bwd_plain_matches_pallas_and_bank_grad(n,
                                                                      dtype):
    x, ub, g = _draw(30 + n, (B, S, D), (A, n, D // n), (B, S, D))
    (tx, jx), (tg, jg) = _pair(x, dtype), _pair(g, dtype)
    dx, du = ref.ref_ether_reflect_batched_bwd(
        tx, torch.from_numpy(ub), torch.from_numpy(IDS), tg)
    assert dx.dtype == dtype and du.dtype == torch.float32
    pdx, ghat = ether_reflect_batched_bwd_pallas(jx, jnp.asarray(ub),
                                                 jnp.asarray(IDS), jg)
    pdu = jops._bank_grad(jnp.asarray(ub), jnp.asarray(IDS), ghat)
    assert _held(dx, pdx, dtype)
    assert _max_err(du, pdu) <= F32_TOL
    if dtype == torch.float32:
        adx, adu, _ = jref.ref_ether_reflect_batched_bwd(
            jx, jnp.asarray(ub), jnp.asarray(IDS), jg)
        assert _max_err(dx, adx) <= F32_TOL and _max_err(du, adu) <= F32_TOL


def test_the_wrappers_take_any_leading_dims_and_every_shape():
    x, u, g = _draw(40, (2, 7, D), (8, D // 8), (2, 7, D))
    tx, tu, tg = map(torch.from_numpy, (x, u, g))
    out = ops.ether_reflect(tx, tu)
    np.testing.assert_array_equal(
        _f32(out), _f32(ref.ref_ether_reflect(tx.reshape(14, D), tu))
        .reshape(2, 7, D))
    dx, du = ops.ether_reflect_bwd(tx, tu, tg)
    want = ref.ref_ether_reflect_bwd(tx.reshape(14, D), tu, tg.reshape(14, D))
    assert dx.shape == (2, 7, D)
    assert _max_err(dx.reshape(14, D), want[0]) <= F32_TOL
    assert _max_err(du, want[1]) <= F32_TOL
    # one row (1-D x), as the JAX wrapper takes it
    np.testing.assert_array_equal(_f32(ops.ether_reflect(tx[0, 0], tu)),
                                  _f32(out[0, 0]))
    # decode: S = 1 through the bank wrapper
    ub = torch.from_numpy(_draw(41, (A, 8, D // 8))[0])
    one = ops.ether_reflect_batched(tx[:, :1].contiguous(), ub,
                                    torch.tensor([A - 1, 2]))
    assert one.shape == (2, 1, D)


@pytest.mark.parametrize("case", ["float16", "u_float64", "n_db", "g_shape",
                                  "strided", "empty", "ids_float",
                                  "bank_shape"])
def test_the_reflection_wrappers_refuse_bad_operands(case):
    x, u, g = (torch.from_numpy(a) for a in _draw(42, (4, 3, D), (8, D // 8),
                                                  (4, 3, D)))
    ub, ids = torch.from_numpy(_draw(43, (A, 8, D // 8))[0]), torch.tensor(
        [0, 1, 2, 3])
    if case == "float16":
        x, g = x.half(), g.half()
    elif case == "u_float64":
        u, ub = u.double(), ub.double()
    elif case == "n_db":
        u, ub = u[:, :-1].contiguous(), ub[:, :, :-1].contiguous()
    elif case == "g_shape":
        g = g[:, :2].contiguous()
    elif case == "strided":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "empty":
        x, g = x[:0], g[:0]
    elif case == "ids_float":
        ids = ids.float()
    else:
        ub = ub[None]
    if case not in ("ids_float", "bank_shape"):
        with pytest.raises(ops.KernelInputError, match="ether_reflect_bwd "
                           "refuses x"):
            ops.ether_reflect_bwd(x, u, g)
        if case != "g_shape":
            with pytest.raises(ops.KernelInputError,
                               match="ether_reflect refuses x"):
                ops.ether_reflect(x, u)
    with pytest.raises(ops.KernelInputError,
                       match="ether_reflect_batched_bwd refuses x"):
        ops.ether_reflect_batched_bwd(x, ub, ids, g)
    if case != "g_shape":
        with pytest.raises(ops.KernelInputError,
                           match="ether_reflect_batched refuses x"):
            ops.ether_reflect_batched(x, ub, ids)


def _leaf(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype).requires_grad_(True)


@pytest.mark.parametrize("op", ["ether_reflect", "ether_reflect_batched"])
def test_dispatch_under_autograd_matches_jax_grad(op):
    """dispatch on ``torch`` under autograd: the op's Function, its
    backward counted once as ``<op>_bwd.torch``; the output, dx and du
    against ``jax.grad`` of a linear probe through the JAX package's
    ``dispatch(op, "pallas")`` (interpret mode, its ``_registry_vjp``).  d =
    128 so that the JAX ``auto`` backward picks its Pallas kernel for the
    bank op too."""
    d, n = 128, 8
    if op == "ether_reflect":
        x, u, p = _draw(50, (2, 7, d), (n, d // n), (2, 7, d))
        extra = ()
    else:
        x, u, p = _draw(51, (B, S, d), (A, n, d // n), (B, S, d))
        extra = (IDS,)
    tx, tu = _leaf(x), _leaf(u)
    execute.reset_counters()
    out = execute.dispatch(op, "torch", tx, tu,
                           *(torch.from_numpy(e) for e in extra))
    assert out.grad_fn is not None
    (out * torch.from_numpy(p)).sum().backward()
    assert execute.counters() == {f"{op}.torch": 1, f"{op}_bwd.torch": 1}
    assert execute.counters(phase="bwd") == {f"{op}_bwd.torch": 1}
    assert execute.counters(phase="fwd") == {f"{op}.torch": 1}
    assert execute.available(op) == ("torch", "cuda")
    assert execute.available(op + "_bwd") == ("torch", "cuda")
    assert execute.is_bwd_op(op + "_bwd") and not execute.is_bwd_op(op)

    def loss(jx, ju):
        y = jexecute.dispatch(op, "pallas", jx, ju,
                              *(jnp.asarray(e) for e in extra))
        return jnp.sum(y * jnp.asarray(p)), y
    jexecute.reset_counters()
    (_, jy), (jdx, jdu) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(jnp.asarray(x),
                                                           jnp.asarray(u))
    assert jexecute.counters(phase="bwd") == {f"{op}_bwd.pallas": 1}
    assert _max_err(out, jy) <= F32_TOL
    assert _max_err(tx.grad, jdx) <= F32_TOL
    assert _max_err(tu.grad, jdu) <= F32_TOL


def test_a_bank_gradient_adds_repeats_and_leaves_unnamed_tenants_at_zero():
    x, ub, p = _draw(60, (B, S, D), (A, 8, D // 8), (B, S, D))
    tx, tu = _leaf(x), _leaf(ub)
    out = execute.dispatch("ether_reflect_batched", "torch", tx, tu,
                           torch.from_numpy(IDS))
    (out * torch.from_numpy(p)).sum().backward()
    unnamed = sorted(set(range(A)) - set(IDS.tolist()))
    assert unnamed == [2, 3]
    assert torch.equal(tu.grad[unnamed], torch.zeros_like(tu.grad[unnamed]))
    # tenant A − 1 served sequences 0 and 2: its row is the sum of each
    # sequence's gradient taken alone
    alone = []
    for b in (0, 2):
        ua = _leaf(ub[A - 1])
        y = execute.dispatch("ether_reflect", "torch",
                             torch.from_numpy(x[b]), ua)
        (y * torch.from_numpy(p[b])).sum().backward()
        alone.append(ua.grad)
    assert _max_err(tu.grad[A - 1], alone[0] + alone[1]) <= F32_TOL
    assert (tu.grad[[0, 1, A - 1]].flatten(1).abs().amax(1) > 0).all()


def _registry_operands(seed=70):
    """Operands of the fourteen forward ops at small widths (d = 24, f =
    16, 4 blocks, rank 3, a bank of 4 tenants, ids [3, 0, 3]), every
    adapter off its identity; and which positions train: x (the
    activation, where there is one) and the adapters, as the JAX suites'
    TRAINABLE_ARGS, w frozen."""
    rng = np.random.default_rng(seed)
    bs, s, d, f, n, r, a = 3, 5, 24, 16, 4, 3, 4

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (shift + scale * rng.standard_normal(shape)).astype(np.float32))
    x, w = t(bs, s, d), t(d, f, scale=d ** -.5)
    ids = torch.tensor([a - 1, 0, a - 1])
    u, v, u2, v2 = t(n, d // n), t(n, d // n), t(n, f // n), t(n, f // n)
    ub, vb = t(a, n, d // n), t(a, n, d // n)
    am, bm, sm = t(d, r), t(r, f), t(r, scale=0.3, shift=1.0)
    ab, bb, sb = t(a, d, r), t(a, r, f), t(a, r, scale=0.3, shift=1.0)
    rr, cc = t(d, scale=0.3, shift=1.0), t(f, scale=0.3, shift=1.0)
    rb, cb = t(a, d, scale=0.3, shift=1.0), t(a, f, scale=0.3, shift=1.0)
    return {
        "ether_reflect": ((x, u), (0, 1)),
        "ether_reflect_batched": ((x, ub, ids), (0, 1)),
        "householder_gemm": ((x, w, u), (0, 2)),
        "ether_merge": ((w, u), (1,)),
        "etherplus_gemm": ((x, w, u, v, u2, v2), (0, 2, 3, 4, 5)),
        "etherplus_merge": ((w, u, v, u2, v2), (1, 2, 3, 4)),
        "delora_gemm": ((x, w, am, bm, sm), (0, 2, 3, 4)),
        "delora_merge": ((w, am, bm, sm), (1, 2, 3)),
        "hyperadapt_gemm": ((x, w, rr, cc), (0, 2, 3)),
        "hyperadapt_merge": ((w, rr, cc), (1, 2)),
        "householder_gemm_batched": ((x, w, ub, ids), (0, 2)),
        "etherplus_reflect_batched": ((x, ub, vb, ids), (0, 1, 2)),
        "delora_gemm_batched": ((x, w, ab, bb, sb, ids), (0, 2, 3, 4)),
        "hyperadapt_gemm_batched": ((x, w, rb, cb, ids), (0, 2, 3)),
    }


def test_the_registry_has_a_function_for_every_forward_op():
    fwd = {op for op, _ in execute._REGISTRY if not execute.is_bwd_op(op)}
    # the two kernels without a backward (none in the JAX package either)
    no_bwd = {"ssd_chunked", "flash_attention"}
    assert set(execute.FUNCTIONS) == fwd - no_bwd
    assert set(_registry_operands()) == set(execute.FUNCTIONS)
    for op in fwd:
        assert execute.available(op) == ("torch", "cuda")
        if op not in no_bwd:
            assert execute.available(op + "_bwd") == ("torch", "cuda")


@pytest.mark.parametrize("op", sorted(_registry_operands()))
def test_dispatch_is_differentiable_for_every_forward_op(op):
    """Each forward op dispatched on ``torch`` under grad runs its
    Function: the output has a grad_fn, ``<op>_bwd.torch`` runs once, and
    the gradients of a linear probe equal plain autograd of the op's plain
    forward (the registry's torch implementation, called outside the
    Function)."""
    args, train = _registry_operands()[op]

    def leaves():
        return [a.clone().requires_grad_(i in train) for i, a in
                enumerate(args)]
    got_in = leaves()
    execute.reset_counters()
    out = execute.dispatch(op, "torch", *got_in)
    assert out.grad_fn is not None
    probe = torch.from_numpy(np.random.default_rng(71).standard_normal(
        tuple(out.shape)).astype(np.float32))
    (out * probe).sum().backward()
    assert execute.counters() == {f"{op}.torch": 1, f"{op}_bwd.torch": 1}
    want_in = leaves()
    want = execute._REGISTRY[(op, "torch")](*want_in)
    (want * probe).sum().backward()
    assert _max_err(out, want) <= F32_TOL
    for i in train:
        assert _max_err(got_in[i].grad, want_in[i].grad) <= GRAD_TOL, i


def test_dispatch_without_grad_calls_the_op_directly():
    args, train = _registry_operands()["householder_gemm"]
    leaves = [a.clone().requires_grad_(i in train) for i, a in
              enumerate(args)]
    execute.reset_counters()
    with torch.no_grad():
        out = execute.dispatch("householder_gemm", "torch", *leaves)
    assert out.grad_fn is None and not out.requires_grad
    out = execute.dispatch("householder_gemm", "torch",
                           *(a.detach() for a in leaves))
    assert out.grad_fn is None
    assert execute.counters() == {"householder_gemm.torch": 2}


def test_ssd_chunked_under_grad_on_torch_is_plain_autograd():
    """``ssd_chunked`` has no Function: on ``torch`` its gradient is plain
    autograd of the plain route (its ``cuda`` route raises NotPortedError
    under grad: tests/test_torch_cuda.py)."""
    xv, a, b, c = _draw(80, (1, 6, 2, 3), (1, 6, 2), (1, 6, 1, 4),
                        (1, 6, 1, 4))
    txv = _leaf(xv)
    ta = torch.from_numpy(-np.abs(a))
    y, final = execute.dispatch("ssd_chunked", "torch", txv, ta,
                                torch.from_numpy(b), torch.from_numpy(c),
                                chunk=4)
    y.sum().backward()
    want = ssd_chunked(_leaf(xv), ta, torch.from_numpy(b),
                       torch.from_numpy(c), chunk=4)
    assert _max_err(y, want[0]) <= F32_TOL
    assert txv.grad is not None and torch.isfinite(txv.grad).all()


@pytest.mark.parametrize("name", methods.available())
def test_method_ops_match_the_jax_registry(name):
    method = methods.get(name)
    assert method.ops == jmethods.get(name).ops
    for op in method.ops:
        assert op in execute.FUNCTIONS
        assert execute.available(op) == ("torch", "cuda")
        assert execute.available(op + "_bwd") == ("torch", "cuda")


def test_the_batched_activations_match_the_jax_transforms():
    x, ub, vb = _draw(90, (B, S, D), (A, 8, D // 8), (A, 8, D // 8))
    tids, jids = torch.from_numpy(IDS), jnp.asarray(IDS)
    got = T.reflect_activation_batched(*map(torch.from_numpy, (x, ub)), tids)
    assert _max_err(got, jT.reflect_activation_batched(
        jnp.asarray(x), jnp.asarray(ub), jids)) <= F32_TOL
    got = T.etherplus_activation_batched(*map(torch.from_numpy, (x, ub, vb)),
                                         tids)
    assert _max_err(got, jT.etherplus_activation_batched(
        jnp.asarray(x), jnp.asarray(ub), jnp.asarray(vb), jids)) <= F32_TOL
