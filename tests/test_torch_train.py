"""The port's training slice held against the JAX package on the CPU: the
plain backward of the reflected GEMM against ``repro.kernels.ref`` and
the interpret-mode Pallas backward kernels, the autograd Function
against ``torch.func.vjp``, ``train_loss`` and its adapter gradients and
a 5-step AdamW/cosine trajectory against the JAX package on the same
weights (``bridge``) and batches (one stream), and, port only, the
trainer's bitwise resume, its checkpoint layout and the train CLI."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import flatten_with_paths as jflatten
from repro.configs import get_config as jget_config
from repro.configs import peft_targets as jpeft_targets
from repro.core.transforms import PEFTConfig as JPEFTConfig
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.kernels import ref as jref
from repro.kernels.gemm_bwd import (reflect_gemm_dw_pallas,
                                    reflect_gemm_dx_pallas)
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch import NotPortedError, bridge
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute
from repro_torch.core.peft import init_adapters, trainable_mask
from repro_torch.core.transforms import PEFTConfig, adapted_dense
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps, train
from repro_torch.models import api, backbone
from repro_torch.models.api import DeviceUnavailableError
from repro_torch.optim import adamw, schedules
from repro_torch.runtime.trainer import Trainer

ARCHS = ["smollm-360m", "llama-2-7b"]
B, S = 2, 16
# float32, normalised max error max|a − b| / max|b|: the same sums (of up
# to 256 terms in the kernels, four layers in the models) taken in
# another order; XLA's and PyTorch's exp/log differ in the last bits
F32_TOL = 1e-5
# gradients of a 4-layer model: the same, through the backward of every
# layer, softmax and cross-entropy
GRAD_TOL = 1e-4
# bf16 (8 mantissa bits), relative Frobenius.  The JAX jnp reference
# rounds û and every intermediate to bf16 (seen: ≤ 8e-3); the Pallas
# kernels compute in f32 and round once, as the port does (seen: ≤ 6e-5)
BF16_TOL = {"jnp": 2e-2, "pallas": 1e-3}
N_STEPS = 5


def _inputs(seed, t, d, f, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32),
            (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
            rng.standard_normal((n, d // n)).astype(np.float32),
            rng.standard_normal((t, f)).astype(np.float32))


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


# ---------------------------------------------------------------------------
# The plain backward and the autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,f,n", [(7, 120, 40, 8), (5, 96, 96, 8),
                                     (3, 240, 24, 8)])
def test_plain_backward_matches_jax_ref(t, d, f, n):
    arrays = _inputs(0, t, d, f, n)
    port = ref.ref_householder_gemm_bwd(*map(torch.from_numpy, arrays))
    want = jref.ref_householder_gemm_bwd(*map(jnp.asarray, arrays))
    for name, p, w in zip(("dx", "dw", "du"), port, want):
        assert _max_err(_np(p), w) < F32_TOL, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4, 8])
def test_plain_backward_matches_interpret_pallas_kernels(n, dtype):
    t, d, f = 128, 256, 128
    x, w, u, g = _inputs(1, t, d, f, n)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt, wt, gt = (torch.from_numpy(a).to(tdt) for a in (x, w, g))
    dx, dw, du = ref.ref_householder_gemm_bwd(xt, wt, torch.from_numpy(u),
                                              gt)
    xj, wj, gj = (jnp.asarray(a, jdt) for a in (x, w, g))
    jdx, jdu = reflect_gemm_dx_pallas(xj, wj, jnp.asarray(u), gj,
                                      block_m=128, block_d=d, block_f=128,
                                      interpret=True)
    jdw = reflect_gemm_dw_pallas(xj, jnp.asarray(u), gj, block_m=128,
                                 block_d=d, block_f=128, w_dtype=jdt,
                                 interpret=True)
    assert dx.dtype == tdt and dw.dtype == tdt and du.dtype == torch.float32
    for name, p, j in (("dx", dx, jdx), ("dw", dw, jdw), ("du", du, jdu)):
        if dtype == "float32":
            assert _max_err(_np(p), j) < F32_TOL, name
        else:
            assert _frob(_np(p), np.asarray(j, np.float32)) \
                < BF16_TOL["pallas"], name
    if dtype == "bfloat16":
        want = jref.ref_householder_gemm_bwd(xj, wj, jnp.asarray(u), gj)
        for name, p, j in zip(("dx", "dw", "du"), (dx, dw, du), want):
            assert _frob(_np(p), np.asarray(j, np.float32)) \
                < BF16_TOL["jnp"], name


@pytest.mark.parametrize("case", ["g_dtype", "g_shape", "g_strided",
                                  "x_float16"])
def test_backward_wrapper_refuses_what_the_kernels_do_not_take(case):
    x, w, u, g = (torch.from_numpy(a) for a in _inputs(3, 4, 96, 64, 8))
    why = {"g_dtype": "g must be", "g_shape": "g must be",
           "g_strided": "contiguous", "x_float16": "float32 or bfloat16"}
    if case == "g_dtype":
        g = g.double()
    elif case == "g_shape":
        g = g[:, :-1].contiguous()
    elif case == "g_strided":
        g = g.t().contiguous().t()
    else:
        x, w, g = x.half(), w.half(), g.half()
    with pytest.raises(ops.KernelInputError,
                       match=r"householder_gemm_bwd refuses .*" + why[case]):
        ops.householder_gemm_bwd(x, w, u, g, need_dw=False)


def test_cpu_backward_wrapper_is_the_plain_version_and_launches_nothing():
    x, w, u, g = (torch.from_numpy(a) for a in _inputs(4, 6, 96, 64, 8))
    ops.reset_launches()
    dx, dw, du = ops.householder_gemm_bwd(x.reshape(2, 3, 96), w, u,
                                          g.reshape(2, 3, 64), need_dw=True)
    want = ref.ref_householder_gemm_bwd(x, w, u, g)
    assert dx.shape == (2, 3, 96)
    for got, wnt in zip((dx.reshape(6, 96), dw, du), want):
        torch.testing.assert_close(got, wnt, rtol=0, atol=0)
    assert ops.householder_gemm_bwd(x, w, u, g, need_dw=False)[1] is None
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)


@pytest.mark.parametrize("w_trains", [False, True])
def test_autograd_function_matches_vjp_of_the_plain_forward(w_trains):
    x, w, u, g = (torch.from_numpy(a)
                  for a in _inputs(2, 6, 96, 40, 8))
    x3, g3 = x.reshape(2, 3, 96), g.reshape(2, 3, 40)
    leaves = [x3.clone().requires_grad_(), w.clone().requires_grad_(w_trains),
              u.clone().requires_grad_()]
    execute.reset_counters()
    ops.reset_launches()
    y = execute.HouseholderGemm.apply(*leaves, "auto")
    y.backward(g3)
    _, vjp = torch.func.vjp(ref.ref_householder_gemm, x3, w, u)
    want = vjp(g3)
    for name, leaf, wnt in zip(("dx", "dw", "du"), leaves, want):
        if name == "dw" and not w_trains:
            assert leaf.grad is None
            continue
        assert _max_err(_np(leaf.grad), _np(wnt)) < F32_TOL, name
    assert execute.counters() == {"householder_gemm.torch": 1,
                                  "householder_gemm_bwd.torch": 1}
    assert ops.launches() == dict.fromkeys(ops.launches(), 0)


def test_no_grad_forward_pays_nothing_for_autograd():
    """Serving (prefill, decode_step, merge_params run under no_grad)
    calls the forward itself: no graph, no backward op."""
    cfg = get_config("smollm-360m", "smoke")
    peft = PEFTConfig(n_blocks=8, targets=peft_targets("smollm-360m"))
    params = api.init_model(cfg, seed=0, device="cpu")
    adapters = init_adapters(torch.Generator().manual_seed(1), params, peft)
    for leaf in (a for _, a in flatten_with_paths(adapters)):
        leaf.requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    execute.reset_counters()
    _, logits = api.prefill(params, adapters, {"tokens": tokens}, cfg, peft)
    assert logits.grad_fn is None and not logits.requires_grad
    assert execute.counters() == {"householder_gemm.torch": 7 * cfg.n_layers,
                                  "flash_attention.torch": cfg.n_layers}
    # and with grad on but nothing to differentiate, the same
    execute.reset_counters()
    y = adapted_dense(torch.randn(3, 96), torch.randn(96, 16), None,
                      {"u": torch.randn(8, 12)}, peft)
    assert y.grad_fn is None
    assert execute.counters() == {"householder_gemm.torch": 1}


# ---------------------------------------------------------------------------
# train_loss, gradients and the optimizer trajectory against JAX
# ---------------------------------------------------------------------------

def _peft_pair(arch):
    return (JPEFTConfig(method="ether", n_blocks=8,
                        targets=jpeft_targets(arch), backend="jnp"),
            PEFTConfig(method="ether", n_blocks=8, targets=peft_targets(arch)))


@functools.lru_cache(maxsize=None)
def _trajectories(arch):
    """5 AdamW/cosine steps of both packages from one JAX state; cached."""
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch)
    jopt = jadamw(jsched.cosine(2e-3, N_STEPS, 2))
    topt = adamw(schedules.cosine(2e-3, N_STEPS, 2))
    jstate = jsteps.init_state(jax.random.PRNGKey(0), cfg, jp, jopt)
    init = _np_tree(jstate["adapters"])
    bridged = bridge.to_torch(_np_tree(jstate))
    tstate = dict(steps.make_state(bridged["params"], bridged["adapters"],
                                   tp, topt),
                  opt_state=bridged["opt_state"], step=bridged["step"])
    jstream = JStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=0)
    tstream = SyntheticLMStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=0)
    jstep = jax.jit(jsteps.make_train_step(cfg, jp, jopt))
    tstep = steps.make_train_step(tcfg, tp, topt)
    jl, tl = [], []
    for i in range(N_STEPS):
        jb = jstream.batch_at(i)
        np.testing.assert_array_equal(jb["tokens"],
                                      tstream.batch_at(i)["tokens"])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v).long()
                                    for k, v in tstream.batch_at(i).items()})
        jl.append([float(jm["loss"]), float(jm["grad_norm"])])
        tl.append([float(tm["loss"]), float(tm["grad_norm"])])
    return dict(jstate=jstate, tstate=tstate, jl=np.array(jl),
                tl=np.array(tl), init=init)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_adapter_grads_match_jax(arch):
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    from repro.core.peft import init_adapters as jinit_adapters
    adapters = jinit_adapters(jax.random.PRNGKey(1), params, jp)
    batch = JStream(vocab=cfg.vocab, batch=B, seq_len=S, seed=3).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a, b: japi.train_loss(params, a, b, cfg, jp), has_aux=True))(
        adapters, {k: jnp.asarray(v) for k, v in batch.items()})

    tparams = bridge.to_torch(_np_tree(params))
    tadapters = bridge.to_torch(_np_tree(adapters))
    leaves = flatten_with_paths(tadapters)
    for _, leaf in leaves:
        leaf.requires_grad_()
    execute.reset_counters()
    tloss, metrics = api.train_loss(
        tparams, tadapters, {k: torch.from_numpy(v).long()
                             for k, v in batch.items()}, tcfg, tp)
    tloss.backward()
    assert metrics["loss"] is tloss
    assert abs(tloss.item() - float(jloss)) / float(jloss) < F32_TOL
    jg = dict(jflatten(jgrads))
    for path, leaf in leaves:
        assert _max_err(_np(leaf.grad), jg[path]) < GRAD_TOL, path
    per_pass = 7 * tcfg.n_layers                 # remat "none" at smoke size
    # and each layer's attention, on its plain route under autograd
    assert execute.counters() == {"householder_gemm.torch": per_pass,
                                  "householder_gemm_bwd.torch": per_pass,
                                  "flash_attention.torch": tcfg.n_layers}


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_cosine_trajectory_matches_jax(arch):
    r = _trajectories(arch)
    # losses and grad norms step by step; then the adapters' total update
    # (final − initial), which the optimizer alone moves
    assert np.abs(r["tl"] - r["jl"]).max() / np.abs(r["jl"]).max() < GRAD_TOL
    jfin = dict(jflatten(_np_tree(r["jstate"]["adapters"])))
    init = dict(jflatten(r["init"]))
    for path, leaf in flatten_with_paths(r["tstate"]["adapters"]):
        assert _max_err(_np(leaf) - init[path],
                        jfin[path] - init[path]) < GRAD_TOL, path
    jopt = dict(jflatten(_np_tree(r["jstate"]["opt_state"])))
    topt = dict(flatten_with_paths(r["tstate"]["opt_state"]))
    assert set(jopt) == set(topt)
    for path, leaf in topt.items():
        if "count" in path:
            assert int(leaf) == int(jopt[path]) == N_STEPS, path
        elif path.split("/")[1] == "mu":            # first moments
            assert _max_err(_np(leaf), jopt[path]) < GRAD_TOL, path
    assert int(r["tstate"]["step"]) == N_STEPS


def test_data_streams_match_jax(tmp_path):
    from repro.data.pipeline import make_stream as jmake_stream
    from repro.data.pipeline import write_synthetic_corpus as jwrite
    from repro_torch.data.pipeline import (make_stream,
                                           write_synthetic_corpus)
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jwrite(jpath, 4000, 512, seed=5)
    write_synthetic_corpus(tpath, 4000, 512, seed=5)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    for kind, kw in (("synthetic", dict(vocab=512, structured=False)),
                     ("synthetic", dict(vocab=512)),
                     ("binary", dict(path=tpath))):
        j = jmake_stream(kind, batch=3, seq_len=16, seed=1,
                         **(dict(kw, path=jpath) if kind == "binary" else kw))
        t = make_stream(kind, batch=3, seq_len=16, seed=1, **kw)
        for step in (0, 1, 50, 200):          # binary: past epoch ends
            jb, tb = j.batch_at(step), t.batch_at(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_match_jax(name):
    make = {"constant": lambda m: m.constant(1e-3),
            "cosine": lambda m: m.cosine(2e-3, 20, 5),
            "wsd": lambda m: m.wsd(2e-3, 20, 5)}[name]
    tf, jf = make(schedules), make(jsched)
    for s in (0, 1, 4, 5, 12, 18, 20, 25):
        got = float(tf(torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(float(jf(jnp.int32(s))), rel=1e-6,
                                    abs=1e-12), s


def test_remat_full_matches_none_and_runs_each_forward_twice():
    base = get_config("llama-2-7b", "smoke")
    _, tp = _peft_pair("llama-2-7b")
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        state = steps.init_state(cfg, tp, adamw(schedules.constant(1e-3)),
                                 seed=0, device="cpu")
        batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLMStream(
            vocab=cfg.vocab, batch=B, seq_len=S).batch_at(0).items()}
        execute.reset_counters()
        loss, _ = api.train_loss(state["params"], state["adapters"], batch,
                                 cfg, tp)
        loss.backward()
        out[remat] = (loss.item(), [leaf.grad for _, leaf in
                                    flatten_with_paths(state["adapters"])],
                      execute.counters())
    per_pass, layers = 7 * base.n_layers, base.n_layers
    # the attention (plain route under autograd) is rerun with its layer
    assert out["none"][2] == {"householder_gemm.torch": per_pass,
                              "householder_gemm_bwd.torch": per_pass,
                              "flash_attention.torch": layers}
    assert out["full"][2] == {"householder_gemm.torch": 2 * per_pass,
                              "householder_gemm_bwd.torch": per_pass,
                              "flash_attention.torch": 2 * layers}
    assert out["full"][0] == out["none"][0]
    for a, b in zip(out["full"][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lm_loss_chunks_equal_the_whole():
    cfg = get_config("smollm-360m", "smoke")
    params = api.init_model(cfg, seed=0, device="cpu")
    hidden = torch.randn(2, 20, cfg.d_model, requires_grad=True)
    labels = torch.randint(0, cfg.vocab, (2, 20))
    mask = (torch.arange(20) < 17).float().expand(2, 20)
    whole = backbone.lm_loss(params, cfg, hidden, labels, mask)
    chunked = backbone.lm_loss(params, dataclasses.replace(cfg, loss_chunk=8),
                               hidden, labels, mask)
    (gw,) = torch.autograd.grad(whole, hidden)
    (gc,) = torch.autograd.grad(chunked, hidden)
    assert abs(whole.item() - chunked.item()) < 1e-6
    torch.testing.assert_close(gc, gw, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# The state, the trainer and the CLI (port only)
# ---------------------------------------------------------------------------

def test_state_paths_match_the_jax_state_and_only_adapters_train():
    cfg = jget_config("smollm-360m", "smoke")
    jp, tp = _peft_pair("smollm-360m")
    jstate = jsteps.init_state(jax.random.PRNGKey(0), cfg, jp,
                               jadamw(jsched.constant(1e-3)))
    tstate = steps.init_state(get_config("smollm-360m", "smoke"), tp,
                              adamw(schedules.constant(1e-3)), device="cpu")
    jpaths = {p: np.shape(v) for p, v in jflatten(jstate)}
    tpaths = {p: tuple(v.shape) for p, v in flatten_with_paths(tstate)}
    assert tpaths == jpaths
    base, adapt = trainable_mask(tstate["params"], tstate["adapters"], tp)
    assert not any(v for _, v in flatten_with_paths(base))
    assert all(v for _, v in flatten_with_paths(adapt))
    assert not any(p.requires_grad for _, p
                   in flatten_with_paths(tstate["params"]))
    assert all(a.requires_grad for _, a
               in flatten_with_paths(tstate["adapters"]))
    # full finetuning: every float base param trains, no adapter does
    base, adapt = trainable_mask(tstate["params"], tstate["adapters"],
                                 dataclasses.replace(tp, method="full"))
    assert all(v for _, v in flatten_with_paths(base))
    assert not any(v for _, v in flatten_with_paths(adapt))


def test_checkpoint_layout_and_bf16_round_trip(tmp_path):
    tree = {"a": {"w": torch.randn(3, 4).to(torch.bfloat16)},
            "opt": ((), {"mu": torch.randn(5), "count":
                         torch.tensor(7, dtype=torch.int32)})}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree, extra={"data": {"step": 7}}, block=True)
    mgr.close()
    assert latest_step(str(tmp_path)) == 7
    with open(tmp_path / "step_7" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == {"a/w": "bfloat16"}
    assert manifest["extra"] == {"data": {"step": 7}}
    with np.load(tmp_path / "step_7" / "arrays.npz") as data:
        assert sorted(data.files) == ["a\x1fw", "opt\x1f1\x1fcount",
                                      "opt\x1f1\x1fmu"]
        raw = data["a\x1fw"]
        assert raw.dtype == np.uint8 and raw.shape == (3, 8)
    mgr = CheckpointManager(str(tmp_path))
    back, extra = mgr.restore(template=tree)
    mgr.close()
    assert extra == {"data": {"step": 7}}
    for (p, a), (_, b) in zip(flatten_with_paths(back),
                              flatten_with_paths(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    os.makedirs(tmp_path / "step_9")           # a crash artifact
    with pytest.warns(UserWarning, match="incomplete"):
        assert latest_step(str(tmp_path)) == 7


def _trainer(tmp_path, name, **kw):
    cfg = get_config("smollm-360m", "smoke")
    peft = PEFTConfig(n_blocks=8, targets=peft_targets("smollm-360m"))
    return Trainer(cfg, peft, adamw(schedules.cosine(2e-3, 6, 2)),
                   ckpt_dir=str(tmp_path / name), ckpt_every=2, seed=0,
                   device="cpu", log_path=str(tmp_path / f"{name}.jsonl"),
                   **kw)


def test_injected_failure_and_auto_restore_end_bitwise_equal(tmp_path):
    stream = SyntheticLMStream(vocab=512, batch=B, seq_len=S, seed=0)
    ref_run = _trainer(tmp_path, "ref")
    ref_run.fit(stream, steps=6)
    ref_run.close()
    crashed = _trainer(tmp_path, "run", fail_at_step=3)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        crashed.fit(stream, steps=6)
    crashed.close()
    assert latest_step(str(tmp_path / "run")) == 2
    resumed = _trainer(tmp_path, "run")
    assert resumed.step == 2 and resumed.data_state.step == 2
    resumed.fit(stream, steps=6)
    resumed.close()
    assert resumed.step == 6 and latest_step(str(tmp_path / "run")) == 6
    for key in ("adapters", "opt_state", "step"):
        got = flatten_with_paths(resumed.state[key])
        want = dict(flatten_with_paths(ref_run.state[key]))
        assert len(got) == len(want)
        for path, leaf in got:
            assert torch.equal(leaf, want[path]), f"{key}/{path}"
    logged = [json.loads(line) for line in
              open(tmp_path / "run.jsonl").read().splitlines()]
    assert [m["step"] for m in logged] == [1, 2, 3, 3, 4, 5, 6]
    assert all(np.isfinite(m["loss"]) for m in logged)


class _SignalAt:
    """A stream that sends ``sig`` to this process when ``batch_at(step)``
    is read."""

    def __init__(self, stream, step, sig):
        self.stream, self.step, self.sig = stream, step, sig

    def batch_at(self, step):
        if step == self.step:
            os.kill(os.getpid(), self.sig)
        return self.stream.batch_at(step)


def test_sigterm_stops_after_the_step_with_a_synchronous_save(tmp_path):
    import signal
    old = signal.getsignal(signal.SIGTERM)
    trainer = _trainer(tmp_path, "pre")
    # the signal lands while the batch of step 3 (cursor 2) is read: that
    # step runs, then the trainer stops and saves
    stream = _SignalAt(SyntheticLMStream(vocab=512, batch=B, seq_len=S), 2,
                       signal.SIGTERM)
    try:
        trainer.fit(stream, steps=6)
        assert signal.getsignal(signal.SIGTERM) is old   # handler put back
    finally:
        signal.signal(signal.SIGTERM, old)
        trainer.close()
    assert trainer.step == 3
    assert latest_step(str(tmp_path / "pre")) == 3     # ckpt_every is 2


def test_train_cli_runs_on_cpu(capsys):
    metrics = train.main(["--device", "cpu", "--variant", "smoke",
                          "--steps", "2", "--batch", "2", "--seq-len", "16"])
    assert "done @ step 2" in capsys.readouterr().out
    assert np.isfinite(metrics["loss"]) and metrics["step"] == 2


def test_train_cli_raises_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="--device cpu"):
        train.main(["--steps", "1"])


# the PEFT modes are ported (tests/test_torch_modes.py); with them the
# CLI still refuses a mesh, an unported architecture and VeRA
@pytest.mark.parametrize("flag", [["--mesh", "2,1"],
                                  ["--mesh", "2,1", "--peft-mode", "weight"],
                                  ["--arch", "mamba2-1.3b",
                                   "--peft-mode", "blockgemm"],
                                  ["--method", "vera"],
                                  ["--method", "vera",
                                   "--peft-mode", "weight"]])
def test_train_cli_refuses_what_is_not_ported(flag):
    with pytest.raises(NotPortedError):
        train.main(["--device", "cpu", "--steps", "1", *flag])
