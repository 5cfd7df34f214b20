"""The port on the card: each CUDA kernel against its plain version, the
serving and training slices (ETHER, ETHER+, DeLoRA, HyperAdapt and the
plain-PyTorch methods) on the card against the same runs on the CPU,
``execute.dispatch`` under autograd on ``cuda`` against ``torch``, and
the flash attention kernel that every dense decoder's serving runs.

Every test here needs a CUDA device and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch (there, without tests/conftest.py, which imports
the JAX package):

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import NotPortedError
from repro_torch.common.pytree import flatten_with_paths, map_with_paths
from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute
from repro_torch.core.peft import (AdapterBank, init_adapter_bank,
                                   init_adapters, merge_params)
from repro_torch.core.transforms import (PEFTConfig, adapted_dense,
                                         resolve_blocks)
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.kernels import etherplus_reflect_bwd, ops, ref
from repro_torch.launch import serve, steps
from repro_torch.models.api import init_model
from repro_torch.optim import adamw, schedules

pytestmark = pytest.mark.cuda

# (T, d, f, n): decode and prefill rows at smollm-360m widths, the paper's
# n = 32, and ragged edges (db = 12, 15)
SHAPES = [(4, 960, 2560, 8), (128, 2560, 960, 8), (128, 960, 320, 32),
          (5, 96, 96, 8), (67, 120, 70, 8)]
# normalised max error: float32 sums in another order; bf16 one output
# rounding (2^-8) apart
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (T, d, f, n) of the backward kernels: smollm-360m's linears at n = 32
# (db = 30 and 80) with a ragged T, and small ragged and tileable shapes
BWD_SHAPES = [(1000, 960, 2560, 32), (1000, 2560, 960, 32),
              (67, 120, 70, 8), (128, 256, 128, 4)]
# du, relative Frobenius: the same f32 math on the same inputs in both
# dtypes (ĝ sums over T in another order)
DU_TOL = 1e-4
# bf16 ETHER+ du2/dv2: how much farther from the float64 composition than
# the plain composition's they may lie (both round y0 to bf16, each in its
# own order of summation; see test_etherplus_backward_kernels_match_plain_
# versions)
EP_Y0_SLACK = 1.25


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the H100 (see README.md)")
    # plain versions in full f32 on the card, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, t, d, f, n, dtype):
    rng = np.random.default_rng(t * d + f + n)
    x = torch.from_numpy(rng.standard_normal((t, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((d, f), np.float32) / d ** .5)
    u = torch.from_numpy(rng.standard_normal((n, d // n), np.float32))
    return x.to(device, dtype), w.to(device, dtype), u.to(device)


def _ep_out_grads_f64(x, w, u1, v1, u2, v2, g):
    """(du2, dv2) of the two-sided ETHER+ linear in float64, y0 = (H⁺x)·W
    unrounded: the reference that neither path's bf16 y0 rounds."""
    def unit(a):
        return a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
                    + ref.EPS)

    def rank2(xx, u, v):
        n, db = u.shape
        xb = xx.reshape(xx.shape[0], n, db)
        uh, vh = unit(u), unit(v)
        return (xb - torch.einsum("tnb,nb->tn", xb, uh)[..., None] * uh
                + torch.einsum("tnb,nb->tn", xb, vh)[..., None] * vh
                ).reshape(xx.shape)

    x, w, u1, v1, u2, v2, g = (a.double() for a in (x, w, u1, v1, u2, v2, g))
    y0 = rank2(x, u1, v1) @ w
    n, db = u2.shape
    yb, gb = y0.reshape(-1, n, db), g.reshape(-1, n, db)
    grads = []
    for a, c in ((u2, -1.0), (v2, 1.0)):
        ah = unit(a)
        ghat = c * (torch.einsum("tn,tnb->nb",
                                 torch.einsum("tnb,nb->tn", yb, ah), gb)
                    + torch.einsum("tn,tnb->nb",
                                   torch.einsum("tnb,nb->tn", gb, ah), yb))
        grads.append(ref.norm_chain(a, ghat))
    return grads


def _max_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def _launched(**counts):
    """Every kernel's launch count: those given, 0 for the rest."""
    return {**dict.fromkeys(ops.launches(), 0), **counts}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_kernels_match_plain_versions(cuda_device, t, d, f, n, dtype):
    x, w, u = _inputs(cuda_device, t, d, f, n, dtype)
    ops.reset_launches()
    y = ops.householder_gemm(x, w, u)
    m = ops.ether_merge(w, u)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(householder_gemm=1, ether_merge=1)
    assert y.dtype == dtype and m.dtype == dtype and y.shape == (t, f)
    assert _max_err(y, ref.ref_householder_gemm(x, w, u)) < TOL[dtype]
    assert _max_err(m, ref.ref_ether_merge(w, u)) < TOL[dtype]


def test_wrappers_refuse_on_the_card_without_fallback(cuda_device):
    x, w, u = _inputs(cuda_device, 4, 96, 64, 8, torch.float32)
    ops.reset_launches()
    with pytest.raises(ops.KernelInputError, match="float32 or bfloat16"):
        ops.householder_gemm(x.half(), w.half(), u)
    with pytest.raises(ops.KernelInputError, match="one device"):
        ops.householder_gemm(x, w.cpu(), u)
    with pytest.raises(ops.KernelInputError, match="contiguous"):
        ops.ether_merge(w.t().contiguous().t(), u)
    assert ops.launches() == _launched()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f,n", BWD_SHAPES)
def test_backward_kernels_match_plain_versions(cuda_device, t, d, f, n,
                                               dtype):
    x, w, u = _inputs(cuda_device, t, d, f, n, dtype)
    g = torch.randn(t, f, generator=torch.Generator().manual_seed(t)
                    ).to(cuda_device, dtype)
    ops.reset_launches()
    dx, dw, du = ops.householder_gemm_bwd(x, w, u, g, need_dw=True)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(reflect_gemm_dx=1, reflect_gemm_dw=1)
    pdx, pdw, pdu = ref.ref_householder_gemm_bwd(x, w, u, g)
    assert dx.dtype == dw.dtype == dtype and du.dtype == torch.float32
    assert _max_err(dx, pdx) < TOL[dtype]
    assert _max_err(dw, pdw) < TOL[dtype]
    assert ((du - pdu).norm() / pdu.norm()).item() < DU_TOL
    ops.reset_launches()
    _, no_dw, du2 = ops.householder_gemm_bwd(x, w, u, g, need_dw=False)
    assert no_dw is None and torch.equal(du2, du)     # no atomics: same bits
    assert ops.launches()["reflect_gemm_dw"] == 0


def test_backward_with_a_trainable_weight_launches_reflect_gemm_dw(
        cuda_device):
    x, w, u = _inputs("cpu", 6, 120, 70, 8, torch.float32)
    g = torch.randn(2, 3, 70, generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().clone().to(dev).requires_grad_() for t in
                  (x.reshape(2, 3, 120), w, u)]
        ops.reset_launches()
        execute.reset_counters()
        execute.HouseholderGemm.apply(*leaves, "auto").backward(g.to(dev))
        grads[str(dev)] = [t.grad for t in leaves]
    assert ops.launches() == _launched(householder_gemm=1, reflect_gemm_dx=1,
                                       reflect_gemm_dw=1)
    assert execute.counters() == {"householder_gemm.cuda": 1,
                                  "householder_gemm_bwd.cuda": 1}
    for card, cpu in zip(grads["cuda"], grads["cpu"]):
        assert _max_err(card, cpu) < TOL[torch.float32]


def test_smoke_train_step_on_the_card_matches_the_cpu(cuda_device):
    # one state drawn on the CPU, one step on each device
    cfg = get_config("smollm-360m", "smoke")
    peft = PEFTConfig(n_blocks=8, targets=peft_targets("smollm-360m"))
    opt = adamw(schedules.cosine(2e-3, 4, 0))
    state = steps.init_state(cfg, peft, opt, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLMStream(
        vocab=cfg.vocab, batch=2, seq_len=16).batch_at(0).items()}
    step = steps.make_train_step(cfg, peft, opt)
    out = {}
    for dev in ("cpu", cuda_device):
        moved = map_with_paths(lambda _, t: t.detach().to(dev)
                               .requires_grad_(t.requires_grad), state)
        ops.reset_launches()
        execute.reset_counters()
        out[str(dev)] = step(moved, {k: v.to(dev) for k, v in batch.items()})
    per_pass = 7 * cfg.n_layers
    # each layer's attention on its plain route under autograd
    assert execute.counters() == {"householder_gemm.cuda": per_pass,
                                  "householder_gemm_bwd.cuda": per_pass,
                                  "flash_attention.torch": cfg.n_layers}
    assert ops.launches() == _launched(householder_gemm=per_pass,
                                       reflect_gemm_dx=per_pass)
    (card, cm), (cpu, pm) = out["cuda"], out["cpu"]
    for k in ("loss", "grad_norm"):
        assert abs(cm[k].item() - pm[k].item()) <= 1e-4 * abs(pm[k].item())
    want = dict(flatten_with_paths(cpu["adapters"]))
    for path, leaf in flatten_with_paths(card["adapters"]):
        assert _max_err(leaf.detach(), want[path].detach()) < 1e-4, path


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("merged", [False, True])
def test_smoke_serving_on_the_card_matches_the_cpu(cuda_device, merged):
    # one set of weights, drawn on the CPU (the CPU and CUDA generators
    # give different numbers for one seed), served on both devices
    cfg = get_config("smollm-360m", "smoke")
    peft = PEFTConfig(n_blocks=8, targets=peft_targets("smollm-360m"))
    params = init_model(cfg, seed=0, device="cpu")
    adapters = init_adapters(torch.Generator().manual_seed(1), params, peft)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    runs = {}
    for dev in ("cpu", cuda_device):
        p, a = _to(params, dev), _to(adapters, dev)
        execute.reset_counters()
        if merged:
            p, a, pc = merge_params(p, a, peft), None, None
        else:
            pc = peft
        runs[str(dev)] = (serve.generate(p, a, tokens.to(dev), cfg, pc, 4),
                          execute.counters())
    (card, calls), (cpu, _) = runs["cuda"], runs["cpu"]
    # every layer's attention of every forward on the flash kernel
    attention = {"flash_attention.cuda": cfg.n_layers * card["forwards"]}
    if merged:
        assert calls == {"ether_merge.cuda": 7 * cfg.n_layers, **attention}
    else:
        assert calls == {"householder_gemm.cuda":
                         7 * cfg.n_layers * card["forwards"], **attention}
    assert _max_err(card["logits"], cpu["logits"]) < 1e-4
    assert torch.equal(card["tokens"], cpu["tokens"])


# ---------------------------------------------------------------------------
# ETHER+: every adapter below has v drawn apart from u (H⁺ ≠ I), so a
# kernel that dropped either direction would disagree
# ---------------------------------------------------------------------------

def _ep_adapters(device, d, f, n, two_sided, seed):
    rng = np.random.default_rng(seed)
    n_out = resolve_blocks(n, f)
    a = [rng.standard_normal((n, d // n), np.float32) for _ in range(2)]
    if two_sided:
        a += [rng.standard_normal((n_out, f // n_out), np.float32)
              for _ in range(2)]
    else:
        a += [None, None]
    return [None if t is None else torch.from_numpy(t).to(device) for t in a]


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f,n", SHAPES)
def test_etherplus_kernels_match_plain_versions(cuda_device, t, d, f, n,
                                                dtype, two_sided):
    x, w, _ = _inputs(cuda_device, t, d, f, n, dtype)
    u1, v1, u2, v2 = _ep_adapters(cuda_device, d, f, n, two_sided, t + f)
    ops.reset_launches()
    y = ops.etherplus_gemm(x, w, u1, v1, u2, v2)
    m = ops.etherplus_merge(w, u1, v1, u2, v2)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(
        etherplus_gemm=1, etherplus_merge_left=1,
        etherplus_merge_right=int(two_sided))
    assert y.dtype == m.dtype == dtype and y.shape == (t, f)
    assert _max_err(y, ref.ref_etherplus_gemm(x, w, u1, v1, u2, v2)) \
        < TOL[dtype]
    assert _max_err(m, ref.ref_etherplus_merge(w, u1, v1, u2, v2)) \
        < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f,n", BWD_SHAPES)
def test_etherplus_backward_kernels_match_plain_versions(cuda_device, t, d,
                                                         f, n, dtype):
    x, w, _ = _inputs(cuda_device, t, d, f, n, dtype)
    u1, v1, u2, v2 = _ep_adapters(cuda_device, d, f, n, True, t + d)
    g = torch.randn(t, f, generator=torch.Generator().manual_seed(t)
                    ).to(cuda_device, dtype)
    ops.reset_launches()
    got = ops.etherplus_gemm_bwd(x, w, u1, v1, u2, v2, g, need_dw=True)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(etherplus_gemm=1,
                                       etherplus_reflect_bwd=1,
                                       reflect_gemm_dx=1, reflect_gemm_dw=1)
    want = ref.ref_etherplus_gemm_bwd(x, w, u1, v1, u2, v2, g)
    # du2 and dv2 sum over y0, which both paths recompute and round to
    # bf16 in sums of their own order: in bf16 they are held against the
    # float64 composition, as close to it as the plain composition (within
    # EP_Y0_SLACK of its distance) plus DU_TOL, and the recomputed y0
    # (the forward's one-sided call, which the backward makes) within one
    # bf16 rounding of the plain version's in every output, give or take
    # 2^-16 of the largest (the f32 sums' own error where an output nearly
    # cancels)
    if dtype == torch.bfloat16:
        exact = _ep_out_grads_f64(x, w, u1, v1, u2, v2, g)
        y0 = ops.etherplus_gemm(x, w, u1, v1).float()
        y0_plain = ref.ref_etherplus_gemm(x, w, u1, v1).float()
        ulp = torch.ldexp(torch.ones_like(y0), torch.frexp(
            torch.maximum(y0.abs(), y0_plain.abs()))[1] - 8)
        assert bool(((y0 - y0_plain).abs() <= ulp + 2.0 ** -16
                     * y0_plain.abs().max()).all())
    for name, a, b in zip(("dx", "dw", "du1", "dv1", "du2", "dv2"), got,
                          want):
        assert a.dtype == b.dtype, name
        if name in ("dx", "dw"):
            assert _max_err(a, b) < TOL[dtype], name
        elif name in ("du2", "dv2") and dtype == torch.bfloat16:
            e = exact[name == "dv2"]
            dist, plain = ((a.double() - e).norm() / e.norm()).item(), (
                (b.double() - e).norm() / e.norm()).item()
            assert dist <= EP_Y0_SLACK * plain + DU_TOL, (name, dist, plain)
        else:
            assert ((a - b).norm() / b.norm()).item() < DU_TOL, name
    # one-sided: the rank-2 dx/dw kernels alone, and no atomics anywhere
    ops.reset_launches()
    one = ops.etherplus_gemm_bwd(x, w, u1, v1, None, None, g, need_dw=False)
    assert ops.launches() == _launched(reflect_gemm_dx=1)
    assert one[1] is None and one[4] is None and one[5] is None
    pdx, pdu, pdv = ref.ref_reflect_gemm_dx(x, w, u1, g, v1)
    assert _max_err(one[0], pdx) < TOL[dtype]
    for a, b in ((one[2], pdu), (one[3], pdv)):
        assert ((a - b).norm() / b.norm()).item() < DU_TOL
    again = ops.etherplus_gemm_bwd(x, w, u1, v1, None, None, g,
                                   need_dw=False)
    assert all(torch.equal(a, b) for a, b in zip(one[:4:2], again[:4:2]))
    # the output-side backward's kernel on its own
    y0 = ref.ref_etherplus_gemm(x, w, u1, v1)
    err, *rb = etherplus_reflect_bwd.launch(y0, u2, v2, g)
    assert err == 0
    for a, b in zip(rb, ref.ref_etherplus_reflect_bwd(y0, u2, v2, g)):
        assert (_max_err(a, b) < TOL[dtype] if a.dtype == dtype
                else ((a - b).norm() / b.norm()).item() < DU_TOL)


def _ep_peft(arch, **kw):
    return PEFTConfig(method="etherplus", n_blocks=8,
                      targets=peft_targets(arch), **kw)


def _perturbed(adapters):
    """v drawn apart from u, as training moves them (init has v = u)."""
    gen = torch.Generator().manual_seed(3)
    return map_with_paths(
        lambda p, t: (t.detach() + 0.5 * torch.randn(t.shape, generator=gen)
                      if p.rsplit("/", 1)[-1].startswith("v") else t.detach()),
        adapters)


@pytest.mark.parametrize("two_sided", [True, False])
def test_etherplus_smoke_train_step_on_the_card_matches_the_cpu(cuda_device,
                                                                two_sided):
    cfg = get_config("smollm-360m", "smoke")
    peft = _ep_peft("smollm-360m", two_sided=two_sided)
    opt = adamw(schedules.cosine(2e-3, 4, 0))
    state = steps.init_state(cfg, peft, opt, seed=0, device="cpu")
    state = steps.make_state(state["params"], _perturbed(state["adapters"]),
                             peft, opt)
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLMStream(
        vocab=cfg.vocab, batch=2, seq_len=16).batch_at(0).items()}
    step = steps.make_train_step(cfg, peft, opt)
    out = {}
    for dev in ("cpu", cuda_device):
        moved = map_with_paths(lambda _, t: t.detach().to(dev)
                               .requires_grad_(t.requires_grad), state)
        ops.reset_launches()
        execute.reset_counters()
        out[str(dev)] = step(moved, {k: v.to(dev) for k, v in batch.items()})
    per_pass = 7 * cfg.n_layers
    assert execute.counters() == {"etherplus_gemm.cuda": per_pass,
                                  "etherplus_gemm_bwd.cuda": per_pass,
                                  "flash_attention.torch": cfg.n_layers}
    sides = int(two_sided)
    assert ops.launches() == _launched(
        etherplus_gemm=(1 + sides) * per_pass,
        etherplus_reflect_bwd=sides * per_pass, reflect_gemm_dx=per_pass)
    (card, cm), (cpu, pm) = out["cuda"], out["cpu"]
    for k in ("loss", "grad_norm"):
        assert abs(cm[k].item() - pm[k].item()) <= 1e-4 * abs(pm[k].item())
    want = dict(flatten_with_paths(cpu["adapters"]))
    for path, leaf in flatten_with_paths(card["adapters"]):
        assert _max_err(leaf.detach(), want[path].detach()) < 1e-4, path


@pytest.mark.parametrize("merged", [False, True])
def test_etherplus_smoke_serving_on_the_card_matches_the_cpu(cuda_device,
                                                             merged):
    cfg = get_config("smollm-360m", "smoke")
    peft = _ep_peft("smollm-360m")
    params = init_model(cfg, seed=0, device="cpu")
    adapters = _perturbed(init_adapters(torch.Generator().manual_seed(1),
                                        params, peft))
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    runs = {}
    for dev in ("cpu", cuda_device):
        p, a = _to(params, dev), _to(adapters, dev)
        execute.reset_counters()
        ops.reset_launches()
        if merged:
            p, a, pc = merge_params(p, a, peft), None, None
        else:
            pc = peft
        runs[str(dev)] = (serve.generate(p, a, tokens.to(dev), cfg, pc, 4),
                          execute.counters(), ops.launches())
    (card, calls, launched), (cpu, _, _) = runs["cuda"], runs["cpu"]
    per_pass = 7 * cfg.n_layers
    attn = cfg.n_layers * card["forwards"]
    if merged:
        assert calls == {"etherplus_merge.cuda": per_pass,
                         "flash_attention.cuda": attn}
        assert launched == _launched(etherplus_merge_left=per_pass,
                                     etherplus_merge_right=per_pass,
                                     flash_attention=attn)
    else:
        assert calls == {"etherplus_gemm.cuda": per_pass * card["forwards"],
                         "flash_attention.cuda": attn}
        assert launched == _launched(
            etherplus_gemm=per_pass * card["forwards"], flash_attention=attn)
    assert _max_err(card["logits"], cpu["logits"]) < 1e-4
    assert torch.equal(card["tokens"], cpu["tokens"])


# ---------------------------------------------------------------------------
# DeLoRA and HyperAdapt: every operand below is off the methods' identity
# init (b ≠ 0, r and c ≠ 1), so a kernel that dropped the low-rank term or
# a scale would disagree
# ---------------------------------------------------------------------------

# (T, d, f): decode and prefill rows at smollm-360m widths and ragged edges
METHOD_SHAPES = [(4, 960, 2560), (128, 2560, 960), (5, 96, 70),
                 (67, 120, 96)]
RANKS = [1, 8, 13, 64]


def _method_inputs(device, t, d, f, r, dtype):
    rng = np.random.default_rng(t * d + f + r)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, w, g = draw(t, d).to(device, dtype), (draw(d, f) / d ** .5).to(
        device, dtype), draw(t, f).to(device, dtype)
    a, b = draw(d, r).to(device), draw(r, f).to(device)
    s = (draw(r).abs() + 0.1).to(device, dtype)
    rr, c = (1 + 0.3 * draw(d)).to(device), (1 + 0.3 * draw(f)).to(device)
    return x, w, g, a, b, s, rr, c


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f", METHOD_SHAPES)
def test_method_kernels_match_plain_versions(cuda_device, t, d, f, dtype, r):
    x, w, _, a, b, s, rr, c = _method_inputs(cuda_device, t, d, f, r, dtype)
    ops.reset_launches()
    out = {"delora_gemm": (ops.delora_gemm(x, w, a, b, s),
                           ref.ref_delora_gemm(x, w, a, b, s)),
           "delora_merge": (ops.delora_merge(w, a, b, s),
                            ref.ref_delora_merge(w, a, b, s)),
           "hyperadapt_gemm": (ops.hyperadapt_gemm(x, w, rr, c),
                               ref.ref_hyperadapt_gemm(x, w, rr, c)),
           "hyperadapt_merge": (ops.hyperadapt_merge(w, rr, c),
                                ref.ref_hyperadapt_merge(w, rr, c))}
    torch.cuda.synchronize()
    assert ops.launches() == _launched(**dict.fromkeys(out, 1))
    for name, (got, want) in out.items():
        assert got.dtype == dtype and got.shape == want.shape, name
        assert _max_err(got, want) < TOL[dtype], name


@pytest.mark.parametrize("need_dw", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f", [(1000, 960, 2560), (1000, 2560, 960),
                                   (67, 120, 70)])
def test_method_backward_compositions_match_plain_versions(
        cuda_device, t, d, f, dtype, need_dw):
    x, w, g, a, b, s, rr, c = _method_inputs(cuda_device, t, d, f, 8, dtype)
    ops.reset_launches()
    got = ops.delora_gemm_bwd(x, w, a, b, s, g, need_dw=need_dw)
    want = ref.ref_delora_gemm_bwd(x, w, a, b, s, g, need_dw=need_dw)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(delora_gemm=1,
                                       reflect_gemm_dw=int(need_dw))
    for name, p, q in zip(("dx", "dw", "da", "db", "ds"), got, want):
        if q is None:
            assert p is None, name
            continue
        assert p.dtype == q.dtype and p.shape == q.shape, name
        # dx and dW: one rounding apart; the rest the same f32 glue
        assert _max_err(p, q) < TOL[dtype], name
    ops.reset_launches()
    got = ops.hyperadapt_gemm_bwd(x, w, rr, c, g, need_dw=need_dw)
    want = ref.ref_hyperadapt_gemm_bwd(x, w, rr, c, g, need_dw=need_dw)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(hyperadapt_gemm=2,
                                       reflect_gemm_dw=int(need_dw))
    for name, p, q in zip(("dx", "dw", "dr", "dc"), got, want):
        if q is None:
            assert p is None, name
            continue
        assert p.dtype == q.dtype and p.shape == q.shape, name
        # dr, dc sum z and y0, each rounded once to the activation dtype
        assert _max_err(p, q) < TOL[dtype], name
    ops.reset_launches()
    gw = torch.randn(d, f, generator=torch.Generator().manual_seed(0)).to(
        cuda_device, dtype)
    for name, p, q in zip(("dw", "dr", "dc"),
                          ops.hyperadapt_merge_bwd(w, rr, c, gw),
                          ref.ref_hyperadapt_merge_bwd(w, rr, c, gw)):
        assert _max_err(p, q) < TOL[dtype], name
    assert ops.launches() == _launched(hyperadapt_merge=1)


def test_delora_gemm_takes_the_largest_rank_and_refuses_beyond(cuda_device):
    x, w, _, a, b, s, _, _ = _method_inputs(cuda_device, 128, 960, 320, 512,
                                            torch.float32)
    assert _max_err(ops.delora_gemm(x, w, a, b, s),
                    ref.ref_delora_gemm(x, w, a, b, s)) < TOL[torch.float32]
    x, w, _, a, b, s, _, _ = _method_inputs(cuda_device, 8, 96, 70, 513,
                                            torch.float32)
    with pytest.raises(ops.KernelInputError, match="r ≤ 512"):
        ops.delora_gemm(x, w, a, b, s)


def _method_peft(method):
    return PEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                      targets=peft_targets("smollm-360m"))


def _off_identity(adapters, method):
    """Every method's adapters moved off its identity init, from a seed."""
    g = torch.Generator().manual_seed(7)
    spread = {("delora", "b"): 0.5, ("lora", "b"): 0.5,
              ("hyperadapt", "r"): 0.2, ("hyperadapt", "c"): 0.2,
              ("oft", "r"): 0.1, ("naive", "m"): 0.1}
    return map_with_paths(
        lambda p, t: (t + spread[(method, p.rsplit("/", 1)[-1])]
                      * torch.randn(t.shape, generator=g)).detach()
        if (method, p.rsplit("/", 1)[-1]) in spread else t.detach(),
        adapters)


@pytest.mark.parametrize("method", ["delora", "hyperadapt", "lora", "oft",
                                    "naive", "full"])
def test_method_smoke_train_step_on_the_card_matches_the_cpu(cuda_device,
                                                             method):
    cfg = get_config("smollm-360m", "smoke")
    peft = _method_peft(method)
    opt = adamw(schedules.cosine(2e-3, 4, 0))
    state = steps.init_state(cfg, peft, opt, seed=0, device="cpu")
    state = steps.make_state(state["params"],
                             _off_identity(state["adapters"], method),
                             peft, opt)
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLMStream(
        vocab=cfg.vocab, batch=2, seq_len=16).batch_at(0).items()}
    step = steps.make_train_step(cfg, peft, opt)
    out = {}
    for dev in ("cpu", cuda_device):
        moved = map_with_paths(lambda _, t: t.detach().to(dev)
                               .requires_grad_(t.requires_grad), state)
        ops.reset_launches()
        execute.reset_counters()
        out[str(dev)] = step(moved, {k: v.to(dev) for k, v in batch.items()})
    per_pass = 7 * cfg.n_layers
    want = {"delora": ({"delora_gemm.cuda": per_pass,
                        "delora_gemm_bwd.cuda": per_pass},
                       _launched(delora_gemm=2 * per_pass)),
            "hyperadapt": ({"hyperadapt_gemm.cuda": per_pass,
                            "hyperadapt_gemm_bwd.cuda": per_pass},
                           _launched(hyperadapt_gemm=3 * per_pass))}.get(
        method, ({}, _launched()))
    want[0]["flash_attention.torch"] = cfg.n_layers
    assert (execute.counters(), ops.launches()) == want
    (card, cm), (cpu, pm) = out["cuda"], out["cpu"]
    for k in ("loss", "grad_norm"):
        assert abs(cm[k].item() - pm[k].item()) <= 1e-4 * abs(pm[k].item())
    if method != "full":
        want = dict(flatten_with_paths(cpu["adapters"]))
        for path, leaf in flatten_with_paths(card["adapters"]):
            assert _max_err(leaf.detach(), want[path].detach()) < 1e-4, path
        return
    # every base param takes Adam's first, sign-like step, which flips
    # where a gradient is at rounding noise: the update as a whole, to
    # the limit chip_smoke.py holds the train phases' updates to
    old = dict(flatten_with_paths(state["params"]))
    want = dict(flatten_with_paths(cpu["params"]))
    num = den = 0.0
    for path, leaf in flatten_with_paths(card["params"]):
        ref_upd = want[path].detach().float() - old[path].float()
        num += (leaf.detach().cpu().float() - old[path].float()
                - ref_upd).square().sum().item()
        den += ref_upd.square().sum().item()
    assert den > 0 and (num / den) ** 0.5 < 5e-2


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("method", ["delora", "hyperadapt"])
def test_method_smoke_serving_on_the_card_matches_the_cpu(cuda_device,
                                                          method, merged):
    cfg = get_config("smollm-360m", "smoke")
    peft = _method_peft(method)
    params = init_model(cfg, seed=0, device="cpu")
    adapters = _off_identity(init_adapters(torch.Generator().manual_seed(1),
                                           params, peft), method)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    runs = {}
    for dev in ("cpu", cuda_device):
        p, a = _to(params, dev), _to(adapters, dev)
        execute.reset_counters()
        ops.reset_launches()
        if merged:
            p, a, pc = merge_params(p, a, peft), None, None
        else:
            pc = peft
        runs[str(dev)] = (serve.generate(p, a, tokens.to(dev), cfg, pc, 4),
                          execute.counters(), ops.launches())
    (card, calls, launched), (cpu, _, _) = runs["cuda"], runs["cpu"]
    per_pass = 7 * cfg.n_layers
    attn = cfg.n_layers * card["forwards"]
    if merged:
        assert calls == {f"{method}_merge.cuda": per_pass,
                         "flash_attention.cuda": attn}
        assert launched == _launched(**{f"{method}_merge": per_pass},
                                     flash_attention=attn)
    else:
        n = per_pass * card["forwards"]
        assert calls == {f"{method}_gemm.cuda": n,
                         "flash_attention.cuda": attn}
        assert launched == _launched(**{f"{method}_gemm": n},
                                     flash_attention=attn)
    assert _max_err(card["logits"], cpu["logits"]) < 1e-4
    assert torch.equal(card["tokens"], cpu["tokens"])


# ---------------------------------------------------------------------------
# Multi-tenant banks: sequence b served by tenant ids[b]
# ---------------------------------------------------------------------------

# (B, S, d, f, n, A): decode and prefill at smollm-360m widths with a
# 64-tenant bank, a ragged S (33), and small ragged widths (db = 15, 24)
BANK_SHAPES = [(4, 1, 960, 2560, 8, 64), (4, 33, 2560, 960, 8, 64),
               (4, 32, 960, 320, 8, 64), (3, 5, 120, 70, 8, 5),
               (4, 7, 96, 96, 4, 3)]


def _bank_inputs(device, b, s, d, f, n, a, dtype, r=8):
    """x, w, the four methods' banks (each tenant drawn apart from the
    others and off its identity) and ids with a repeat and A − 1."""
    rng = np.random.default_rng(b * s + d + f + a + r)

    def draw(*shape, dt=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(device, dt)
    n_out = resolve_blocks(n, f)
    banks = {"u": draw(a, n, d // n), "v": draw(a, n, d // n),
             "u2": draw(a, n_out, f // n_out),
             "v2": draw(a, n_out, f // n_out),
             "a": draw(a, d, r), "b": draw(a, r, f),
             "s": (draw(a, r).abs() + 0.1).to(dtype),
             "r": 1 + 0.3 * draw(a, d), "c": 1 + 0.3 * draw(a, f)}
    ids = torch.tensor([5 % a, 17 % a, 5 % a][:b - 1] + [a - 1],
                       dtype=torch.int32, device=device)
    w = (draw(d, f) / d ** .5).to(dtype)
    return draw(b, s, d, dt=dtype), w, banks, ids


def _bank_calls(x, w, k, ids):
    """The four bank wrappers on one input: name → (kernel, plain)."""
    y0 = x @ w
    return {
        "householder_gemm_batched": (
            lambda i: ops.householder_gemm_batched(x, w, k["u"], i),
            lambda i: ref.ref_householder_gemm_batched(x, w, k["u"], i)),
        "etherplus_reflect_batched": (
            lambda i: ops.etherplus_reflect_batched(y0, k["u2"], k["v2"], i),
            lambda i: ref.ref_etherplus_reflect_batched(y0, k["u2"], k["v2"],
                                                        i)),
        "delora_gemm_batched": (
            lambda i: ops.delora_gemm_batched(x, w, k["a"], k["b"], k["s"], i),
            lambda i: ref.ref_delora_gemm_batched(x, w, k["a"], k["b"],
                                                  k["s"], i)),
        "hyperadapt_gemm_batched": (
            lambda i: ops.hyperadapt_gemm_batched(x, w, k["r"], k["c"], i),
            lambda i: ref.ref_hyperadapt_gemm_batched(x, w, k["r"], k["c"],
                                                      i))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,f,n,a", BANK_SHAPES)
def test_bank_kernels_match_plain_versions(cuda_device, b, s, d, f, n, a,
                                           dtype):
    x, w, k, ids = _bank_inputs(cuda_device, b, s, d, f, n, a, dtype)
    outside = ids.clone()
    outside[-1] = a + 3                     # clamped into the bank: A − 1
    for name, (kernel, plain) in _bank_calls(x, w, k, ids).items():
        ops.reset_launches()
        got = kernel(ids)
        torch.cuda.synchronize()
        assert ops.launches() == _launched(**{name: 1}), name
        assert got.dtype == dtype and got.shape[:2] == (b, s)
        assert _max_err(got, plain(ids)) < TOL[dtype], name
        assert torch.equal(kernel(ids.long()), got), name
        assert torch.equal(kernel(outside), got), name
        assert torch.equal(plain(outside), plain(ids)), name


def test_bank_rows_match_single_tenant_kernels(cuda_device):
    """Each row of a bank GEMM against the single-tenant kernel of its own
    tenant, and distinct tenants' rows apart."""
    b, s, d, f = 4, 3, 960, 320
    x, w, k, ids = _bank_inputs(cuda_device, b, s, d, f, 8, 64,
                                torch.float32)
    bank = {"hh": ops.householder_gemm_batched(x, w, k["u"], ids),
            "dl": ops.delora_gemm_batched(x, w, k["a"], k["b"], k["s"], ids),
            "ha": ops.hyperadapt_gemm_batched(x, w, k["r"], k["c"], ids)}
    for i, t in enumerate(ids.tolist()):
        one = {"hh": ops.householder_gemm(x[i], w, k["u"][t]),
               "dl": ops.delora_gemm(x[i], w, k["a"][t], k["b"][t],
                                     k["s"][t]),
               "ha": ops.hyperadapt_gemm(x[i], w, k["r"][t], k["c"][t])}
        for name in bank:
            assert _max_err(bank[name][i], one[name]) < TOL[torch.float32]
    for name, y in bank.items():            # tenants 5 and 17 differ
        assert _max_err(y[0], y[1]) > 1e-2, name


def test_bank_wrappers_refuse_on_the_card_without_fallback(cuda_device):
    x, w, k, ids = _bank_inputs(cuda_device, 2, 3, 96, 64, 4, 3,
                                torch.float32)
    ops.reset_launches()
    with pytest.raises(ops.KernelInputError, match="int32 or int64"):
        ops.householder_gemm_batched(x, w, k["u"], ids.float())
    with pytest.raises(ops.KernelInputError, match="int32 or int64"):
        ops.hyperadapt_gemm_batched(x, w, k["r"], k["c"], ids[:1])
    with pytest.raises(ops.KernelInputError, match="one device"):
        ops.delora_gemm_batched(x, w, k["a"], k["b"], k["s"], ids.cpu())
    with pytest.raises(ops.KernelInputError, match="u_bank must be"):
        ops.householder_gemm_batched(x, w, k["u"][:, :3], ids)
    with pytest.raises(ops.KernelInputError, match="v_bank must be"):
        ops.etherplus_reflect_batched(x, k["u"], k["v"][:2], ids)
    with pytest.raises(ops.KernelInputError, match="s_bank must be"):
        ops.delora_gemm_batched(x, w, k["a"], k["b"], k["s"].double(), ids)
    with pytest.raises(ops.KernelInputError, match="c_bank must be"):
        ops.hyperadapt_gemm_batched(x, w, k["r"], k["c"][:, :5], ids)
    with pytest.raises(ops.KernelInputError, match=r"\(B, S, d\)"):
        ops.hyperadapt_gemm_batched(x[0], w, k["r"], k["c"], ids)
    assert ops.launches() == _launched()


# each leaf moved off the method's identity (ETHER+ v = u, DeLoRA b = 0,
# HyperAdapt r = c = 1); the noise spans the tenant axis, so every tenant
# moves differently
BANK_MOVES = {"v1": lambda t, z: t + 0.5 * z, "v2": lambda t, z: t + 0.5 * z,
              "b": lambda t, z: z, "lam": lambda t, z: 2 + 0.5 * z,
              "r": lambda t, z: 1 + 0.1 * z, "c": lambda t, z: 1 + 0.1 * z}


@pytest.mark.parametrize("method", ["ether", "etherplus", "delora",
                                    "hyperadapt"])
def test_bank_smoke_serving_on_the_card_matches_the_cpu(cuda_device, method):
    """A bank of 8 tenants at smoke width, drawn on the CPU and served on
    both devices: every adapted linear on its bank kernel on the card."""
    cfg = get_config("smollm-360m", "smoke")
    pc = PEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                    targets=peft_targets("smollm-360m"))
    params = init_model(cfg, seed=0, device="cpu")
    bank = init_adapter_bank(1, params, pc, 8)
    gen = torch.Generator().manual_seed(3)

    def move(path, t):
        fn = BANK_MOVES.get(path.rsplit("/", 1)[-1])
        return t if fn is None else fn(t, torch.randn(t.shape, generator=gen))
    tree = map_with_paths(move, bank.tree)
    tokens = torch.randint(0, cfg.vocab, (3, 8),
                           generator=torch.Generator().manual_seed(2))
    ids = torch.tensor([5, 1, 7], dtype=torch.int32)
    runs = {}
    for dev in ("cpu", cuda_device):
        bk = AdapterBank(_to(tree, dev), 8, bank.stack_ndims)
        execute.reset_counters()
        ops.reset_launches()
        runs[str(dev)] = (serve.generate(_to(params, dev), bk,
                                         tokens.to(dev), cfg, pc, 4,
                                         tenant_ids=ids.to(dev)),
                          execute.counters(), ops.launches())
    (card, calls, launched), (cpu, _, _) = runs["cuda"], runs["cpu"]
    op = {"ether": "householder_gemm_batched",
          "etherplus": "etherplus_reflect_batched"}.get(
              method, f"{method}_gemm_batched")
    n = 7 * cfg.n_layers * card["forwards"] * (2 if method == "etherplus"
                                               else 1)
    attn = cfg.n_layers * card["forwards"]
    assert calls == {f"{op}.cuda": n, "flash_attention.cuda": attn}
    assert launched == _launched(**{op: n}, flash_attention=attn)
    assert _max_err(card["logits"], cpu["logits"]) < 1e-4
    assert torch.equal(card["tokens"], cpu["tokens"])


# ---------------------------------------------------------------------------
# Weight mode: the merge backwards
# ---------------------------------------------------------------------------

# (d, f, n): smollm-360m's linears at n = 32 (left db 30 and 80; right
# db_out 30, 10 and 80), its down_proj at n = 8 (left db 320: the strips
# in shared memory in bf16, re-read in f32), Llama-2-7B's down_proj at
# n = 8 (left db 1,376: re-read in both) and its transpose (right db_out
# 1,376), and a ragged shape (right db_out 10)
MERGE_SHAPES = [(960, 960, 32), (960, 320, 32), (960, 2560, 32),
                (2560, 960, 32), (2560, 960, 8), (11008, 256, 8),
                (256, 11008, 8), (120, 70, 8)]


def _merge_operands(device, d, f, n, dtype):
    rng = np.random.default_rng(d * 7 + f + n)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    n_out = resolve_blocks(n, f)
    w = (draw(d, f) / d ** .5).to(device, dtype)
    g = draw(d, f).to(device, dtype)
    u, v = draw(n, d // n).to(device), draw(n, d // n).to(device)
    u2, v2 = (draw(n_out, f // n_out).to(device) for _ in range(2))
    return w, g, u, v, u2, v2


def _frob(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("need_dw", [False, True])
@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f,n", MERGE_SHAPES)
def test_merge_left_bwd_matches_its_plain_version(cuda_device, d, f, n, dtype,
                                                  rank, need_dw):
    w, g, u, v, _, _ = _merge_operands(cuda_device, d, f, n, dtype)
    v = v if rank == 2 else None
    ops.reset_launches()
    got = ops.merge_left_bwd(w, u, g, v, need_dw=need_dw)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(merge_left_bwd=1)
    want = ref.ref_merge_left_bwd(w, u, g, v, need_dw=need_dw)
    assert len(got) == len(want) == rank + 1
    if need_dw:
        assert got[0].dtype == dtype
        assert _max_err(got[0], want[0]) < TOL[dtype]
    else:
        assert got[0] is None
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and _frob(a, b) < DU_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f,n", MERGE_SHAPES)
def test_merge_right_bwd_matches_its_plain_version(cuda_device, d, f, n,
                                                   dtype):
    w, g, _, _, u2, v2 = _merge_operands(cuda_device, d, f, n, dtype)
    ops.reset_launches()
    dw, du, dv = ops.merge_right_bwd(w, u2, v2, g)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(merge_right_bwd=1)
    # the plain version: the rank-2 reflection backward of w's rows
    pdw, pdu, pdv = ref.ref_etherplus_reflect_bwd(w, u2, v2, g)
    assert dw.dtype == dtype and _max_err(dw, pdw) < TOL[dtype]
    assert _frob(du, pdu) < DU_TOL and _frob(dv, pdv) < DU_TOL


def test_merge_bwd_wrappers_refuse_on_the_card_without_fallback(cuda_device):
    w, g, u, v, u2, v2 = _merge_operands(cuda_device, 120, 70, 8,
                                         torch.float32)
    for call in (lambda: ops.merge_left_bwd(w, u, g.cpu(), need_dw=True),
                 lambda: ops.merge_left_bwd(w, u, g.to(torch.bfloat16),
                                            need_dw=False),
                 lambda: ops.merge_right_bwd(w, u2, v2.cpu(), g),
                 lambda: ops.etherplus_merge_bwd(w, u, v, u2, v2.cpu(), g,
                                                 need_dw=False)):
        with pytest.raises(ops.KernelInputError):
            call()


@pytest.mark.parametrize("method", ["ether", "etherplus", "etherplus_1s"])
def test_merge_functions_take_an_autograd_step_on_the_card(cuda_device,
                                                           method):
    """y = x @ merge(W) in weight mode at smollm-360m's k_proj (f 320,
    db_out 10), bf16: the kernels' path (EtherMerge / EtherPlusMerge
    through the merge kernels and their backwards) against the plain
    path on the card; W frozen, so no dW."""
    d, f, n = 960, 320, 32
    w, _, u, v, u2, v2 = _merge_operands(cuda_device, d, f, n, torch.bfloat16)
    x = torch.randn(64, d, generator=torch.Generator().manual_seed(1)).to(
        cuda_device, torch.bfloat16)
    name = "ether" if method == "ether" else "etherplus"
    adapter = ({"u": u} if method == "ether" else
               {"u1": u, "v1": v, "u2": u2, "v2": v2}
               if method == "etherplus" else {"u1": u, "v1": v})
    grads = {}
    for backend in ("auto", "torch"):
        peft = PEFTConfig(method=name, n_blocks=n, mode="weight",
                          two_sided=method == "etherplus", backend=backend)
        leaves = {k: t.clone().requires_grad_() for k, t in adapter.items()}
        execute.reset_counters()
        ops.reset_launches()
        y = adapted_dense(x, w, None, leaves, peft)
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        grads[backend] = {k: t.grad for k, t in leaves.items()}
        if backend == "auto":
            op = "ether_merge" if method == "ether" else "etherplus_merge"
            assert execute.counters() == {f"{op}.cuda": 1,
                                          f"{op}_bwd.cuda": 1}
            assert ops.launches() == (
                _launched(ether_merge=1, merge_left_bwd=1)
                if method == "ether" else
                _launched(etherplus_merge_left=2, etherplus_merge_right=1,
                          merge_right_bwd=1, merge_left_bwd=1)
                if method == "etherplus" else
                _launched(etherplus_merge_left=1, merge_left_bwd=1))
    for k, gr in grads["auto"].items():
        # the merged W' and so the cotangent G = xᵀ(dL/dy) pass through
        # bf16 roundings that may flip between the two paths
        assert torch.isfinite(gr).all() and _frob(
            gr, grads["torch"][k]) < TOL[torch.bfloat16], k


@pytest.mark.parametrize("method", ["ether", "etherplus", "delora",
                                    "hyperadapt"])
def test_weight_mode_smoke_train_step_on_the_card_matches_the_cpu(
        cuda_device, method):
    cfg = get_config("smollm-360m", "smoke")
    peft = dataclasses.replace(_method_peft(method), mode="weight")
    opt = adamw(schedules.cosine(2e-3, 4, 0))
    state = steps.init_state(cfg, peft, opt, seed=0, device="cpu")
    moved = (_perturbed(state["adapters"]) if method == "etherplus"
             else _off_identity(state["adapters"], method))
    state = steps.make_state(state["params"], moved, peft, opt)
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLMStream(
        vocab=cfg.vocab, batch=2, seq_len=16).batch_at(0).items()}
    step = steps.make_train_step(cfg, peft, opt)
    out = {}
    for dev in ("cpu", cuda_device):
        moved = map_with_paths(lambda _, t: t.detach().to(dev)
                               .requires_grad_(t.requires_grad), state)
        ops.reset_launches()
        execute.reset_counters()
        out[str(dev)] = step(moved, {k: v.to(dev) for k, v in batch.items()})
    pp = 7 * cfg.n_layers                    # remat "none" at smoke size
    op = f"{method}_merge"
    assert execute.counters() == {f"{op}.cuda": pp, f"{op}_bwd.cuda": pp,
                                  "flash_attention.torch": cfg.n_layers}
    assert ops.launches() == {
        "ether": _launched(ether_merge=pp, merge_left_bwd=pp),
        "etherplus": _launched(etherplus_merge_left=2 * pp,
                               etherplus_merge_right=pp,
                               merge_right_bwd=pp, merge_left_bwd=pp),
        "delora": _launched(delora_merge=pp),
        "hyperadapt": _launched(hyperadapt_merge=pp)}[method]
    (card, cm), (cpu, pm) = out["cuda"], out["cpu"]
    for k in ("loss", "grad_norm"):
        assert abs(cm[k].item() - pm[k].item()) <= 1e-4 * abs(pm[k].item())
    want = dict(flatten_with_paths(cpu["adapters"]))
    for path, leaf in flatten_with_paths(card["adapters"]):
        assert _max_err(leaf.detach(), want[path].detach()) < 1e-4, path


# ---------------------------------------------------------------------------
# Training through a bank: the bank backwards
# ---------------------------------------------------------------------------

# (B, S, d, f, n, A): decode (S = 1), a train-like S = 16 and a ragged
# S = 100 (tiles of 32 rows never straddle two sequences) at smollm-360m
# widths with a 64-tenant bank, n ∈ {8, 32}, and small ragged widths
BANK_BWD_SHAPES = [(4, 1, 960, 2560, 8, 64), (4, 16, 960, 320, 32, 64),
                   (3, 100, 2560, 960, 32, 64), (3, 5, 120, 70, 8, 5)]


def _bank_bwd_ids(ids, a):
    """Phase-2 style ids with a negative one: [5, 17, 5, ..., A − 1] with
    the second replaced by −1 (tenant A − 1 twice, from both ends)."""
    out = ids.clone()
    if out.numel() > 2:
        out[1] = -1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,f,n,a", BANK_BWD_SHAPES)
def test_bank_backward_kernels_match_plain_versions(cuda_device, b, s, d, f,
                                                    n, a, dtype):
    """householder_gemm_batched_bwd (dx, ĝ_seq, du_bank),
    householder_gemm_batched_dw and etherplus_reflect_batched_bwd against
    their plain versions; untouched tenants exactly zero; bitwise the same
    on a second run."""
    from repro_torch.kernels import batched
    x, w, k, ids = _bank_inputs(cuda_device, b, s, d, f, n, a, dtype)
    ids = _bank_bwd_ids(ids, a)
    rng = np.random.default_rng(b + s + d)
    g = torch.from_numpy(rng.standard_normal((b, s, f), np.float32)).to(
        cuda_device, dtype)
    gd = torch.from_numpy(rng.standard_normal((b, s, d), np.float32)).to(
        cuda_device, dtype)
    named = set(ref.bank_index(ids, a).tolist())
    ops.reset_launches()
    dx, dw, du = ops.householder_gemm_batched_bwd(x, w, k["u"], ids, g,
                                                  need_dw=True)
    ex, eu, ev = ops.etherplus_reflect_batched_bwd(x, k["u"], k["v"], ids,
                                                   gd)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(householder_gemm_batched_bwd=1,
                                       householder_gemm_batched_dw=1,
                                       etherplus_reflect_batched_bwd=1)
    pdx, pgh = ref.ref_householder_gemm_batched_bwd(x, w, k["u"], ids, g)
    pdw = ref.ref_householder_gemm_batched_dw(x, k["u"], ids, g, dtype)
    pex, pgu, pgv = ref.ref_etherplus_reflect_batched_bwd(x, k["u"], k["v"],
                                                          ids, gd)
    assert _max_err(dx, pdx) < TOL[dtype]
    assert _max_err(dw, pdw) < TOL[dtype]
    assert _max_err(ex, pex) < TOL[dtype]
    for got, want in ((du, ref.bank_grad(k["u"], ids, pgh)),
                      (eu, ref.bank_grad(k["u"], ids, pgu)),
                      (ev, ref.bank_grad(k["v"], ids, pgv))):
        assert _frob(got, want) < DU_TOL
        for t in range(a):
            assert (got[t].abs().max().item() > 0) == (t in named), t
    # the per-sequence ĝ, the Pallas kernels' second (and third) outputs
    err, _, gh, _ = batched.householder_gemm_batched_bwd(x, w, k["u"], ids, g)
    assert err == 0 and _frob(gh, pgh) < DU_TOL
    err, _, gu, gv, _, _ = batched.etherplus_reflect_batched_bwd(
        x, k["u"], k["v"], ids, gd)
    assert err == 0 and _frob(gu, pgu) < DU_TOL and _frob(gv, pgv) < DU_TOL
    # no float atomics: the same bits again
    again = ops.householder_gemm_batched_bwd(x, w, k["u"], ids, g,
                                             need_dw=True)
    for p, q in zip((dx, dw, du), again):
        assert torch.equal(p, q)
    for p, q in zip((ex, eu, ev), ops.etherplus_reflect_batched_bwd(
            x, k["u"], k["v"], ids, gd)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("need_dw", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,f,n,a", BANK_BWD_SHAPES)
def test_bank_backward_compositions_match_plain_versions(
        cuda_device, b, s, d, f, n, a, dtype, need_dw):
    """DeLoRA's and HyperAdapt's bank backwards (their kernels: the bank
    forwards on Wᵀ, reflect_gemm_dw with a zero hyperplane for dW) against
    their plain versions."""
    x, w, k, ids = _bank_inputs(cuda_device, b, s, d, f, n, a, dtype)
    ids = _bank_bwd_ids(ids, a)
    g = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (b, s, f), np.float32)).to(cuda_device, dtype)
    cases = {
        "delora": (lambda m: m.delora_gemm_batched_bwd(
            x, w, k["a"], k["b"], k["s"], ids, g, need_dw=need_dw)
            if m is ops else m.ref_delora_gemm_batched_bwd(
                x, w, k["a"], k["b"], k["s"], ids, g, need_dw=need_dw),
            _launched(delora_gemm_batched=1, reflect_gemm_dw=int(need_dw))),
        "hyperadapt": (lambda m: m.hyperadapt_gemm_batched_bwd(
            x, w, k["r"], k["c"], ids, g, need_dw=need_dw)
            if m is ops else m.ref_hyperadapt_gemm_batched_bwd(
                x, w, k["r"], k["c"], ids, g, need_dw=need_dw),
            _launched(hyperadapt_gemm_batched=2,
                      reflect_gemm_dw=int(need_dw)))}
    for name, (run, want_launches) in cases.items():
        ops.reset_launches()
        got = run(ops)
        torch.cuda.synchronize()
        assert ops.launches() == want_launches, name
        for i, (p, q) in enumerate(zip(got, run(ref))):
            assert (p is None) == (q is None), (name, i)
            if q is not None:
                assert _max_err(p, q) < TOL[dtype], (name, i)


def test_bank_backward_wrappers_refuse_on_the_card_without_fallback(
        cuda_device):
    x, w, k, ids = _bank_inputs(cuda_device, 2, 3, 96, 64, 4, 3,
                                torch.float32)
    g = torch.zeros(2, 3, 64, device=cuda_device)
    ops.reset_launches()
    with pytest.raises(ops.KernelInputError, match="g must be"):
        ops.householder_gemm_batched_bwd(x, w, k["u"], ids, g[:, :2],
                                         need_dw=False)
    with pytest.raises(ops.KernelInputError, match="one device"):
        ops.etherplus_reflect_batched_bwd(x, k["u"], k["v"], ids,
                                          torch.zeros_like(x).cpu())
    with pytest.raises(ops.KernelInputError, match="int32 or int64"):
        ops.delora_gemm_batched_bwd(x, w, k["a"], k["b"], k["s"],
                                    ids.float(), g, need_dw=False)
    with pytest.raises(ops.KernelInputError, match="c_bank must be"):
        ops.hyperadapt_gemm_batched_bwd(x, w, k["r"], k["c"][:, :5], ids, g,
                                        need_dw=False)
    assert ops.launches() == _launched()


@pytest.mark.parametrize("method", ["ether", "etherplus", "delora",
                                    "hyperadapt"])
def test_bank_smoke_train_steps_on_the_card_match_the_cpu(cuda_device,
                                                          method):
    """Two steps through a bank of 8 tenants at smoke width (every tenant
    off its identity), on both devices: every adapted linear's forward and
    backward on its bank kernels on the card, the losses, grad norms and
    bank updates as on the CPU, untouched tenants unmoved."""
    cfg = get_config("smollm-360m", "smoke")
    pc = PEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                    targets=peft_targets("smollm-360m"))
    params = init_model(cfg, seed=0, device="cpu")
    bank = init_adapter_bank(1, params, pc, 8)
    gen = torch.Generator().manual_seed(3)

    def move(path, t):
        fn = BANK_MOVES.get(path.rsplit("/", 1)[-1])
        return t if fn is None else fn(t, torch.randn(t.shape, generator=gen))
    tree = map_with_paths(move, bank.tree)
    stream = SyntheticLMStream(vocab=cfg.vocab, batch=3, seq_len=16, seed=0)
    ids = torch.tensor([5, 1, 5], dtype=torch.int32)
    opt = adamw(schedules.constant(1e-2))
    runs = {}
    for dev in ("cpu", cuda_device):
        bk = AdapterBank(_to(tree, dev), 8, bank.stack_ndims)
        state = steps.make_bank_state(_to(params, dev), bk, opt)
        step = steps.make_bank_train_step(cfg, pc, opt, bk)
        execute.reset_counters()
        ops.reset_launches()
        metrics = []
        for i in range(2):
            batch = {kk: torch.from_numpy(v).long().to(dev)
                     for kk, v in stream.batch_at(i).items()}
            state, m = step(state, batch, ids.to(dev))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs[str(dev)] = (state, metrics, execute.counters(), ops.launches())
    (card, cm, calls, launched), (cpu, pm, _, _) = runs["cuda"], runs["cpu"]
    op = {"ether": "householder_gemm_batched",
          "etherplus": "etherplus_reflect_batched"}.get(
              method, f"{method}_gemm_batched")
    n = 7 * cfg.n_layers * 2 * (2 if method == "etherplus" else 1)
    # each layer's attention on its plain route under autograd, 2 steps
    assert calls == {f"{op}.cuda": n, f"{op}_bwd.cuda": n,
                     "flash_attention.torch": 2 * cfg.n_layers}
    fwd = {"delora": 2 * n, "hyperadapt": 3 * n}.get(method, n)
    bwd = ({f"{op}_bwd": n} if method in ("ether", "etherplus") else {})
    assert launched == _launched(**{op: fwd}, **bwd)
    for (cl, cg), (pl, pg) in zip(cm, pm):
        assert abs(cl - pl) / pl < 1e-5 and abs(cg - pg) / pg < 1e-4
    init = dict(flatten_with_paths(tree))
    for path, leaf in flatten_with_paths(card["bank"]):
        upd, want = leaf.cpu() - init[path], (
            dict(flatten_with_paths(cpu["bank"]))[path] - init[path])
        assert _frob(upd, want) < 1e-3, path
        nd = bank.stack_ndims[path.rsplit("/", 1)[0]]
        for t in (0, 2, 3, 4, 6, 7):                 # no id names them
            assert torch.equal(leaf.select(nd, t).cpu(),
                               init[path].select(nd, t)), (path, t)


# ---------------------------------------------------------------------------
# Mamba-2: the SSD chunk-scan kernel and serving
# ---------------------------------------------------------------------------

# log-decay a = −scale·softplus(N(0, 1)): a pass-through (a = 0), the
# model's range, and strong decay (exp underflows beyond the diagonal)
SSD_DECAY = {"zero": 0.0, "moderate": 1.0, "strong": 50.0}


def _ssd_operands(device, b, s, h, p, g, n, decay, bc_dtype, seed=0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    a = -SSD_DECAY[decay] * torch.nn.functional.softplus(draw(b, s, h))
    return (draw(b, s, h, p).to(device), a.to(device),
            (0.5 * draw(b, s, g, n)).to(device, bc_dtype),
            (0.5 * draw(b, s, g, n)).to(device, bc_dtype),
            draw(b, h, n, p).to(device))


def _ssd_close(got, want):
    """Normalised max error ≤ 1e-4; exactly equal where the plain version
    is all 0 (a chunk's decay exp(cum_L) underflows under strong decay)."""
    if want.abs().max().item() == 0:
        assert torch.equal(got, want)
    else:
        assert _max_err(got, want) < TOL[torch.float32]


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", list(SSD_DECAY))
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [8, 32, 64, 256])
def test_ssd_chunk_matches_its_plain_version(cuda_device, chunk, g, decay,
                                             bc_dtype):
    """The kernel against ``ref_ssd_chunk`` on the same card tensors at
    mamba2-1.3b's head widths (P = 64, N = 128), and the ``ssd_chunked``
    dispatch's ``cuda`` route (the kernel plus the inter-chunk
    recurrence) against its ``torch`` route with S not a multiple of the
    chunk and a nonzero initial state.  Normalised max error ≤ 1e-4:
    float32 sums in another order, and the chunk's cumsum taken as a
    warp scan."""
    xv, a, b, c, init = _ssd_operands(cuda_device, 2, 2 * chunk, 4, 64, g,
                                      128, decay, bc_dtype)
    ops.reset_launches()
    got = ops.ssd_chunk(xv, a, b, c, chunk)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(ssd_chunk=1)
    for k, want in zip(got, ref.ref_ssd_chunk(xv, a, b, c, chunk)):
        assert k.dtype == torch.float32 and k.shape == want.shape
        assert torch.isfinite(k).all()
        _ssd_close(k, want)
    s = 2 * chunk + 3
    xv, a, b, c, init = _ssd_operands(cuda_device, 2, s, 4, 64, g, 128,
                                      decay, bc_dtype, seed=1)
    for state in (None, init):
        (y, final), (wy, wfinal) = (
            execute.dispatch("ssd_chunked", be, xv, a, b, c, chunk=chunk,
                             initial_state=state)
            for be in ("cuda", "torch"))
        _ssd_close(y, wy)
        _ssd_close(final, wfinal)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 15, 3, 5, 3, 7, 5),
                                               (3, 200, 6, 80, 2, 200, 100),
                                               (1, 1, 2, 64, 1, 128, 1)])
def test_ssd_chunk_takes_ragged_tiles(cuda_device, b, s, h, p, g, n, chunk):
    xv, a, bb, cc, _ = _ssd_operands(cuda_device, b, s, h, p, g, n,
                                     "moderate", torch.float32)
    for k, want in zip(ops.ssd_chunk(xv, a, bb, cc, chunk),
                       ref.ref_ssd_chunk(xv, a, bb, cc, chunk)):
        _ssd_close(k, want)


def test_ssd_wrappers_refuse_on_the_card_without_fallback(cuda_device):
    xv, a, b, c, _ = _ssd_operands(cuda_device, 1, 16, 4, 8, 2, 6,
                                   "moderate", torch.float32)
    ops.reset_launches()
    with pytest.raises(ops.KernelInputError, match="multiple of chunk"):
        ops.ssd_chunk(xv, a, b, c, 5)
    with pytest.raises(ops.KernelInputError, match="one device"):
        ops.ssd_chunk(xv, a.cpu(), b, c, 8)
    with pytest.raises(ops.KernelInputError, match="contiguous"):
        execute.dispatch("ssd_chunked", "cuda", xv, a, b[..., :3],
                         c[..., :3])
    assert ops.launches() == _launched()


@pytest.mark.parametrize("merged", [False, True])
def test_mamba2_smoke_serving_on_the_card_matches_the_cpu(cuda_device,
                                                          merged):
    """The Mamba-2 smoke model (weights drawn on the CPU) served on both
    devices: every prefill layer's scan on the SSD kernel, every adapted
    linear on its ETHER kernel, logits and greedy tokens as on the CPU."""
    cfg = get_config("mamba2-1.3b", "smoke")
    peft = PEFTConfig(n_blocks=8, targets=peft_targets("mamba2-1.3b"))
    params = init_model(cfg, seed=0, device="cpu")
    adapters = init_adapters(torch.Generator().manual_seed(1), params, peft)
    tokens = torch.randint(0, cfg.vocab, (2, 19),
                           generator=torch.Generator().manual_seed(2))
    runs = {}
    for dev in ("cpu", cuda_device):
        p, a = _to(params, dev), _to(adapters, dev)
        execute.reset_counters()
        ops.reset_launches()
        if merged:
            p, a, pc = merge_params(p, a, peft), None, None
        else:
            pc = peft
        runs[str(dev)] = (serve.generate(p, a, tokens.to(dev), cfg, pc, 4),
                          execute.counters(), ops.launches())
    (card, calls, launched), (cpu, _, _) = runs["cuda"], runs["cpu"]
    scans = 2 * cfg.n_layers                    # two prefills, one a layer
    if merged:
        assert calls == {"ether_merge.cuda": 2 * cfg.n_layers,
                         "ssd_chunked.cuda": scans}
        assert launched == _launched(ether_merge=2 * cfg.n_layers,
                                     ssd_chunk=scans)
    else:
        hh = 2 * cfg.n_layers * card["forwards"]
        assert calls == {"householder_gemm.cuda": hh,
                         "ssd_chunked.cuda": scans}
        assert launched == _launched(householder_gemm=hh, ssd_chunk=scans)
    assert _max_err(card["logits"], cpu["logits"]) < 1e-4
    assert torch.equal(card["tokens"], cpu["tokens"])


@pytest.mark.parametrize("method", ["ether", "etherplus", "delora",
                                    "hyperadapt"])
def test_mamba2_smoke_bank_serving_on_the_card_matches_the_cpu(cuda_device,
                                                               method):
    """``serve --tenants`` on Mamba-2 at smoke width: a bank of 4 tenants
    (each off its identity) on in_proj and out_proj, served on both
    devices: the bank kernels and the SSD kernel on the card, logits and
    greedy tokens as on the CPU."""
    cfg = get_config("mamba2-1.3b", "smoke")
    pc = PEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                    targets=peft_targets("mamba2-1.3b"))
    params = init_model(cfg, seed=0, device="cpu")
    bank = init_adapter_bank(1, params, pc, 4)
    gen = torch.Generator().manual_seed(3)

    def move(path, t):
        fn = BANK_MOVES.get(path.rsplit("/", 1)[-1])
        return t if fn is None else fn(t, torch.randn(t.shape, generator=gen))
    tree = map_with_paths(move, bank.tree)
    tokens = torch.randint(0, cfg.vocab, (3, 19),
                           generator=torch.Generator().manual_seed(2))
    ids = torch.tensor([3, 1, 3], dtype=torch.int32)
    runs = {}
    for dev in ("cpu", cuda_device):
        bk = AdapterBank(_to(tree, dev), 4, bank.stack_ndims)
        execute.reset_counters()
        runs[str(dev)] = (serve.generate(_to(params, dev), bk,
                                         tokens.to(dev), cfg, pc, 4,
                                         tenant_ids=ids.to(dev)),
                          execute.counters())
    (card, calls), (cpu, _) = runs["cuda"], runs["cpu"]
    op = {"ether": "householder_gemm_batched",
          "etherplus": "etherplus_reflect_batched"}.get(
              method, f"{method}_gemm_batched")
    n = 2 * cfg.n_layers * card["forwards"] * (2 if method == "etherplus"
                                               else 1)
    assert calls == {f"{op}.cuda": n, "ssd_chunked.cuda": 2 * cfg.n_layers}
    assert _max_err(card["logits"], cpu["logits"]) < 1e-4
    assert torch.equal(card["tokens"], cpu["tokens"])


# the registry's standalone reflections: (T, d, n) single-tenant and
# (B, S, d, n, A) through a bank, odd and full widths: db 32 and 12 on an
# odd T, smollm-360m's train layer (n = 32: db 30, 80), its decode rows
# (n = 8) and Llama-2-7B's widest block (11008 / 8 = 1376)
REFLECT_SHAPES = [(13, 96, 3), (13, 96, 8), (1024, 960, 32),
                  (1024, 2560, 32), (4, 960, 8), (67, 11008, 8)]
REFLECT_BANK_SHAPES = [(4, 13, 96, 8, 5), (8, 128, 960, 32, 64),
                       (4, 1, 2560, 8, 64), (3, 37, 120, 8, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,n", REFLECT_SHAPES)
def test_reflect_kernels_match_plain_versions(cuda_device, t, d, n, dtype):
    rng = np.random.default_rng(t + d + n)
    x, g = (torch.from_numpy(rng.standard_normal((t, d), np.float32))
            .to(cuda_device, dtype) for _ in range(2))
    u = torch.from_numpy(rng.standard_normal((n, d // n), np.float32)).to(
        cuda_device)
    ops.reset_launches()
    y = ops.ether_reflect(x, u)
    dx, du = ops.ether_reflect_bwd(x, u, g)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(ether_reflect=1, ether_reflect_bwd=1)
    assert y.dtype == dtype and dx.dtype == dtype and du.dtype == torch.float32
    assert _max_err(y, ref.ref_ether_reflect(x, u)) < TOL[dtype]
    pdx, pdu = ref.ref_ether_reflect_bwd(x, u, g)
    assert _max_err(dx, pdx) < TOL[dtype]
    assert _frob(du, pdu) < DU_TOL
    # the same inputs give the same bits: no float atomics
    assert torch.equal(ops.ether_reflect_bwd(x, u, g)[1], du)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d,n,a", REFLECT_BANK_SHAPES)
def test_reflect_bank_kernels_match_plain_versions(cuda_device, b, s, d, n, a,
                                                   dtype):
    rng = np.random.default_rng(b * s + d + n + a)
    x, g = (torch.from_numpy(rng.standard_normal((b, s, d), np.float32))
            .to(cuda_device, dtype) for _ in range(2))
    ub = torch.from_numpy(rng.standard_normal((a, n, d // n), np.float32)).to(
        cuda_device)
    # a repeat and the last tenant A − 1; an id ≥ A maps to A − 1
    ids = torch.tensor(([a - 1, 1 % a, a - 1, 0] * b)[:b], dtype=torch.int32,
                       device=cuda_device)
    ops.reset_launches()
    y = ops.ether_reflect_batched(x, ub, ids)
    dx, du = ops.ether_reflect_batched_bwd(x, ub, ids, g)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(ether_reflect_batched=1,
                                       ether_reflect_batched_bwd=1)
    assert _max_err(y, ref.ref_ether_reflect_batched(x, ub, ids)) < TOL[dtype]
    pdx, pdu = ref.ref_ether_reflect_batched_bwd(x, ub, ids, g)
    assert _max_err(dx, pdx) < TOL[dtype] and _frob(du, pdu) < DU_TOL
    named = set(ids.tolist())
    for t in range(a):
        assert (du[t].abs().max().item() > 0) == (t in named), t
    outside = ids.clone()
    outside[0] = a + 3
    assert torch.equal(ops.ether_reflect_batched(x, ub, outside), y)
    assert torch.equal(ops.ether_reflect_batched_bwd(x, ub, outside, g)[1], du)
    assert torch.equal(ops.ether_reflect_batched(x, ub, ids.long()), y)


def test_reflect_wrappers_refuse_on_the_card_without_fallback(cuda_device):
    x = torch.randn(2, 3, 96, device=cuda_device)
    u = torch.randn(8, 12, device=cuda_device)
    ub = torch.randn(3, 8, 12, device=cuda_device)
    ids = torch.tensor([0, 2], device=cuda_device)
    ops.reset_launches()
    with pytest.raises(ops.KernelInputError, match="one device"):
        ops.ether_reflect(x, u.cpu())
    with pytest.raises(ops.KernelInputError, match="n·db = d"):
        ops.ether_reflect_bwd(x, u[:, :5].contiguous(), x)
    with pytest.raises(ops.KernelInputError, match="int32 or int64"):
        ops.ether_reflect_batched(x, ub, ids.float())
    with pytest.raises(ops.KernelInputError, match="g must be"):
        ops.ether_reflect_batched_bwd(x, ub, ids, x.half())
    assert ops.launches() == _launched()


def _registry_operands(device, seed=70):
    """Operands of the fourteen forward ops at small widths (d = 24, f =
    16, 4 blocks, rank 3, a bank of 4 tenants, ids [3, 0, 3]), every
    adapter off its identity, and the positions that train: x and the
    adapters, w frozen (the JAX suites' TRAINABLE_ARGS, and x)."""
    rng = np.random.default_rng(seed)
    bs, s, d, f, n, r, a = 3, 5, 24, 16, 4, 3, 4

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.standard_normal(
            shape)).astype(np.float32)).to(device)
    x, w = t(bs, s, d), t(d, f, scale=d ** -.5)
    ids = torch.tensor([a - 1, 0, a - 1], device=device)
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


@pytest.mark.parametrize("op", sorted(execute.FUNCTIONS))
def test_dispatch_on_cuda_is_differentiable(cuda_device, op):
    """``dispatch(op, "cuda", ...)`` under grad runs the op's Function: the
    output has a grad_fn, ``<op>_bwd.cuda`` runs once and nothing runs the
    plain versions, and the gradients equal the ``torch`` route's on the
    card.  (Before the registry took its Functions, the cuda route handed
    back a tensor written through ctypes, with no gradient.)"""
    args, train = _registry_operands(cuda_device)[op]
    probe = None
    grads = {}
    for backend in ("cuda", "torch"):
        leaves = [a.clone().requires_grad_(i in train)
                  for i, a in enumerate(args)]
        execute.reset_counters()
        out = execute.dispatch(op, backend, *leaves)
        assert out.grad_fn is not None, backend
        if probe is None:
            probe = torch.randn(out.shape, device=cuda_device,
                                generator=torch.Generator(
                                    cuda_device).manual_seed(1))
        (out * probe).sum().backward()
        assert execute.counters() == {f"{op}.{backend}": 1,
                                      f"{op}_bwd.{backend}": 1}
        grads[backend] = (out, [leaves[i].grad for i in train])
    (got, dgot), (want, dwant) = grads["cuda"], grads["torch"]
    assert _max_err(got, want) < TOL[torch.float32]
    for i, a, b in zip(train, dgot, dwant):
        assert _max_err(a, b) < TOL[torch.float32], i


def test_ssd_chunked_under_grad_on_cuda_raises(cuda_device):
    """ssd_chunked has no backward on the card: under grad its cuda route
    raises NotPortedError instead of an output without a gradient."""
    xv, a, b, c, _ = _ssd_operands(cuda_device, 1, 16, 4, 8, 2, 6,
                                   "moderate", torch.float32)
    xv.requires_grad_(True)
    execute.reset_counters()
    with pytest.raises(NotPortedError, match="ssd_chunked"):
        execute.dispatch("ssd_chunked", "cuda", xv, a, b, c, chunk=8)
    assert execute.counters() == {}
    with torch.no_grad():
        y, _ = execute.dispatch("ssd_chunked", "cuda", xv, a, b, c, chunk=8)
    assert y.shape == xv.shape


# ---------------------------------------------------------------------------
# Flash attention: every dense decoder's prefill and decode attention
# ---------------------------------------------------------------------------

# (B, H, Hkv, S, T, D, q_offset, window): ragged S and T (not multiples of
# the 64-row tiles), D 32, 64 and 128, MHA and GQA 4:1 and 5:1, windows, a
# cached prefix, decode rows, and rows that see no key (the last two)
FLASH_SHAPES = [(2, 4, 1, 77, 77, 64, 0, None),
                (1, 5, 1, 130, 130, 128, 0, 33),
                (2, 3, 3, 65, 200, 32, 135, None),
                (3, 15, 5, 1, 48, 64, 47, None),
                (2, 40, 8, 1, 300, 128, 299, None),
                (1, 8, 2, 100, 190, 128, 90, 70),
                (1, 4, 2, 200, 128, 64, 136, 16),
                (2, 2, 1, 9, 5, 32, -7, None)]
# f32: normalised max error (sums over up to 300 keys in another order);
# bf16: relative Frobenius norm, one rounding of an f32 result each
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _flash_operands(device, b, h, hkv, s, t, d, dtype):
    rng = np.random.default_rng(b * h + s * t + d)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, dtype)
    return draw(b, h, s, d), draw(b, hkv, t, d), draw(b, hkv, t, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,t,d,q_offset,window", FLASH_SHAPES)
def test_flash_attention_matches_its_plain_version(cuda_device, b, h, hkv, s,
                                                   t, d, q_offset, window,
                                                   dtype):
    q, k, v = _flash_operands(cuda_device, b, h, hkv, s, t, d, dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches() == _launched(flash_attention=1)
    want = ref.ref_flash_attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == (b, h, s, d)
    empty = (want == 0).all(dim=-1)
    assert torch.equal(got[empty], want[empty])           # exact zeros
    if bool(empty.all()):
        return
    if dtype == torch.float32:
        assert _max_err(got, want) < FLASH_TOL[dtype]
    else:
        diff = (got.float() - want.float()).norm() / want.float().norm()
        assert diff.item() < FLASH_TOL[dtype]


def test_flash_attention_counts_one_launch_a_call(cuda_device):
    q, k, v = _flash_operands(cuda_device, 1, 4, 2, 16, 16, 64,
                              torch.bfloat16)
    ops.reset_launches()
    for i in range(1, 4):
        ops.flash_attention(q, k, v, q_offset=0)
        assert ops.launches()["flash_attention"] == i


def test_flash_attention_refuses_on_the_card_without_fallback(cuda_device):
    q, k, v = _flash_operands(cuda_device, 1, 4, 2, 16, 16, 80,
                              torch.float32)
    ops.reset_launches()
    with pytest.raises(ops.KernelInputError, match="head widths"):
        ops.flash_attention(q, k, v)
    q, k, v = _flash_operands(cuda_device, 1, 4, 2, 16, 16, 64,
                              torch.float32)
    with pytest.raises(ops.KernelInputError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v)
    with pytest.raises(ops.KernelInputError, match="one device"):
        ops.flash_attention(q, k.cpu(), v)
    assert ops.launches() == _launched()


def test_flash_attention_under_grad_on_cuda_raises(cuda_device):
    """flash_attention has no backward (nor has the Pallas kernel): under
    grad its cuda route raises NotPortedError; the models' attention
    dispatches its plain version under autograd instead, counted as
    ``flash_attention.torch``."""
    from repro_torch.models import attention
    q, k, v = _flash_operands(cuda_device, 1, 4, 2, 16, 16, 64,
                              torch.float32)
    q.requires_grad_(True)
    execute.reset_counters()
    with pytest.raises(NotPortedError, match="flash_attention"):
        execute.dispatch("flash_attention", "cuda", q, k, v)
    out = attention.attention_core(q, k, v, backend="cuda")
    assert (execute.counters() == {"flash_attention.torch": 1}
            and out.grad_fn is not None)
    with torch.no_grad():
        got = execute.dispatch("flash_attention", "cuda", q, k, v)
    assert execute.counters() == {"flash_attention.torch": 1,
                                  "flash_attention.cuda": 1}
    assert _max_err(got, out.detach()) < FLASH_TOL[torch.float32]


def test_flash_attention_does_not_repeat_kv(cuda_device):
    """A GQA call at T = 4096 allocates its output and nothing near the
    8× KV that repeating the 4 KV heads to 32 would take."""
    q, k, v = _flash_operands(cuda_device, 1, 32, 4, 16, 4096, 128,
                              torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ops.flash_attention(q, k, v, q_offset=4080)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    repeated = 2 * k.numel() * k.element_size() * (32 // 4)
    out_bytes = out.numel() * out.element_size()
    assert extra <= out_bytes + (1 << 20) < repeated
