"""The port's attention slice held against the JAX package on the CPU: the
flash kernel's plain version (``ref_flash_attention``) and its wrapper
(``ops.flash_attention``) against the interpret-mode Pallas kernel and
the JAX ref; the models' attention (``attention_core``, prefill and
decode, through ``dispatch(..., "torch")``) against JAX's
``attention_core`` and ``_decode_attend``; the untied-head dense
decoders (qwen2.5, deepseek-coder) and minicpm end to end against the
JAX package; the JAX wrapper's fallback that drops ``q_offset``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import flatten_with_paths as jflatten
from repro.configs import get_config as jget_config
from repro.configs import get_module as jget_module
from repro.configs import peft_targets as jpeft_targets
from repro.core import peft as jpeft
from repro.core.transforms import PEFTConfig as JPEFTConfig
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import api as japi
from repro.models import attention as jattn
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.configs import get_config, get_module, peft_targets
from repro_torch.core import execute
from repro_torch.core.transforms import PEFTConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import KernelInputError
from repro_torch.launch import serve
from repro_torch.models import api, attention

# float32, normalised max error max|a − b| / max|b|: the same f32 sums in
# another order, XLA's and PyTorch's exp in the last bits
F32_TOL = 1e-5
# bfloat16: both round one f32 result once; a rounding may flip (2^-8)
BF16_TOL = 2e-2
# the models end to end, as tests/test_torch_models.py and
# tests/test_torch_train.py hold them
GRAD_TOL = 1e-4
ARCHS = ["qwen2.5-32b", "deepseek-coder-33b", "minicpm-2b"]
B, P, GEN, S_TRAIN = 2, 8, 4, 16


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _np(t):
    return t.detach().float().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _qkv(seed, b, h, hkv, s, t, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _attend_np(q, k, v, q_offset, *, causal=True, window=None):
    """Attention with query row i at q_offset + i, in float64 numpy: the
    independent yardstick of the q_offset fault."""
    rep = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    logits = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(d)
    qpos = q_offset + np.arange(s)[:, None]
    kpos = np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = np.where(mask, logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    e = np.exp(logits - np.where(np.isfinite(m), m, 0.0))
    p = e / np.maximum(e.sum(-1, keepdims=True), 1e-30)
    return np.einsum("bhst,bhtd->bhsd", p, v.astype(np.float64))


# ---------------------------------------------------------------------------
# The kernel's plain version and wrapper against the Pallas kernel
# ---------------------------------------------------------------------------

# (b, h, hkv, s, t, d): tests/test_kernels.py's flash shapes (MHA,
# GQA 4:1 and 2:1 at D 64 and 128), GQA 5:1 (qwen2.5's 40 over 8) at
# D = 128, and a cached prefix (T = S + 128)
PALLAS_SHAPES = [(1, 4, 4, 256, 256, 64), (2, 8, 2, 128, 128, 64),
                 (1, 2, 1, 256, 256, 128), (1, 5, 1, 128, 128, 128),
                 (1, 5, 1, 128, 256, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,prefix", [(None, False), (64, True)])
@pytest.mark.parametrize("b,h,hkv,s,t,d", PALLAS_SHAPES)
def test_wrapper_and_plain_match_interpret_pallas(b, h, hkv, s, t, d, window,
                                                  prefix, dtype):
    # q_offset 0, or T − S (the prefix's queries after the cached keys)
    q_offset = t - s if prefix else 0
    arrays = _qkv(0, b, h, hkv, s, t, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = flash_attention_pallas(*(jnp.asarray(a, jdt) for a in arrays),
                                  causal=True, window=window,
                                  q_offset=q_offset, interpret=True)
    q, k, v = _torch(arrays, tdt)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              q_offset=q_offset)
    plain = ref.ref_flash_attention(q, k, v, causal=True, window=window,
                                    q_offset=q_offset)
    assert got.dtype == plain.dtype == tdt and got.shape == (b, h, s, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _max_err(_np(got), np.asarray(want, np.float32)) < tol
    assert _max_err(_np(plain), np.asarray(want, np.float32)) < tol


@pytest.mark.parametrize("window", [None, 3, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t", [(7, 7), (5, 19), (1, 33)])
def test_plain_matches_jax_ref_call_for_call(s, t, causal, window):
    # q_offset=None is the JAX ref's t − s, at any S and T
    arrays = _qkv(1, 2, 6, 2, s, t, 64)
    want = jref.ref_flash_attention(*map(jnp.asarray, arrays),
                                    causal=causal, window=window)
    got = ref.ref_flash_attention(*_torch(arrays), causal=causal,
                                  window=window)
    assert _max_err(_np(got), want) < F32_TOL


def test_fully_masked_rows_are_the_pallas_kernels_zeros():
    # window 16 and queries at 136.. against 128 keys: most rows see no key
    arrays = _qkv(2, 1, 2, 1, 256, 128, 64)
    kw = dict(causal=True, window=16, q_offset=136)
    want = np.asarray(flash_attention_pallas(*map(jnp.asarray, arrays),
                                             interpret=True, **kw))
    got = _np(ops.flash_attention(*_torch(arrays), **kw))
    empty = np.all(want == 0.0, axis=-1)
    assert empty.sum() > 200 and np.isfinite(got).all()
    np.testing.assert_array_equal(got[empty], 0.0)
    np.testing.assert_array_equal(np.all(got == 0.0, axis=-1), empty)
    assert _max_err(got, want) < F32_TOL


def test_jax_wrapper_drops_q_offset_on_its_fallback():
    # S = 200 is not tileable by 128: ops.flash_attention (the JAX
    # wrapper) falls back to ref_flash_attention without q_offset and puts
    # the queries at T − S = 184 instead of 0 (ROADMAP Queue 3)
    arrays = _qkv(3, 1, 2, 1, 200, 384, 64)
    truth = _attend_np(*arrays, q_offset=0)
    jax_out = np.asarray(jops.flash_attention(*map(jnp.asarray, arrays),
                                              causal=True, q_offset=0))
    port_out = _np(ops.flash_attention(*_torch(arrays), causal=True,
                                       q_offset=0))
    assert np.abs(jax_out - truth).max() > 1.0
    assert _max_err(port_out, truth) < F32_TOL
    # at q_offset = T − S the two placements coincide
    jax_at = np.asarray(jops.flash_attention(*map(jnp.asarray, arrays),
                                             causal=True, q_offset=184))
    assert _max_err(_np(ops.flash_attention(*_torch(arrays),
                                            q_offset=184)), jax_at) < F32_TOL


@pytest.mark.parametrize("bad", ["d80", "heads", "dtype", "layout", "rank",
                                 "empty", "offset"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = _torch(_qkv(4, 1, 4, 2, 8, 8, 64))
    kw = {}
    if bad == "d80":
        q, k, v = _torch(_qkv(4, 1, 4, 2, 8, 8, 80))
    elif bad == "heads":
        q = torch.zeros(1, 3, 8, 64)
    elif bad == "dtype":
        k = k.bfloat16()
    elif bad == "layout":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "rank":
        q = q[0]
    elif bad == "empty":
        q = q[:, :, :0]
    else:
        kw = {"q_offset": 2.0}
    with pytest.raises(KernelInputError, match="flash_attention refuses"):
        ops.flash_attention(q, k, v, **kw)


# ---------------------------------------------------------------------------
# The models' attention through dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("s,q_chunk", [(13, 4), (13, 512), (1, 512)])
def test_attention_core_through_dispatch_matches_jax(s, q_chunk, window):
    arrays = _qkv(5, 2, 5, 1, s, 13, 16)
    offset = 13 - s
    want = jattn.attention_core(*map(jnp.asarray, arrays), window=window,
                                q_offset=offset, q_chunk=q_chunk)
    execute.reset_counters()
    with torch.no_grad():
        got = attention.attention_core(*_torch(arrays), window=window,
                                       q_offset=offset, q_chunk=q_chunk,
                                       backend="torch")
    assert execute.counters() == {"flash_attention.torch": 1}
    assert _max_err(_np(got), want) < F32_TOL


@pytest.mark.parametrize("cursor", [0, 6, 11])
def test_decode_attend_through_dispatch_matches_jax(cursor):
    # q (B, H, 1, D) against a 12-slot cache whose slots past the cursor
    # hold junk: causality masks them
    q, ck, cv = _qkv(6, 2, 6, 2, 1, 12, 32)
    qpos = np.full((2, 1), cursor, np.int32)
    want = jattn._decode_attend(jnp.asarray(q), jnp.asarray(ck),
                                jnp.asarray(cv), jnp.asarray(qpos))
    execute.reset_counters()
    with torch.no_grad():
        got = attention.attention_core(*_torch((q, ck, cv)),
                                       q_offset=cursor, backend="torch")
    assert execute.counters() == {"flash_attention.torch": 1}
    assert _max_err(_np(got), want) < F32_TOL
    # the wrapper's plain version (the kernel's) agrees on this row
    kern = ops.flash_attention(*_torch((q, ck, cv)), q_offset=cursor)
    assert _max_err(_np(kern), want) < F32_TOL


def test_attention_core_under_grad_runs_plain_autograd():
    q, k, v = (t.requires_grad_() for t in _torch(_qkv(7, 1, 4, 2, 9, 9, 16)))
    execute.reset_counters()
    out = attention.attention_core(q, k, v, q_chunk=4, backend="torch")
    assert execute.counters() == {"flash_attention.torch": 1}
    out.square().sum().backward()
    want = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref.ref_flash_attention(*want, q_offset=0).square().sum().backward()
    for got_t, want_t in zip((q, k, v), want):
        assert _max_err(_np(got_t.grad), _np(want_t.grad)) < F32_TOL


# ---------------------------------------------------------------------------
# The dense decoders with untied heads (and minicpm) against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_fields_equal(arch, variant):
    assert (dataclasses.asdict(get_config(arch, variant))
            == dataclasses.asdict(jget_config(arch, variant)))
    assert peft_targets(arch) == jpeft_targets(arch)
    mod, jmod = get_module(arch), jget_module(arch)
    assert mod.ARCH == jmod.ARCH
    assert (getattr(mod, "TRAIN_SCHEDULE", None)
            == getattr(jmod, "TRAIN_SCHEDULE", None))


def _peft_pair(arch):
    return (JPEFTConfig(method="ether", n_blocks=8,
                        targets=jpeft_targets(arch), backend="jnp"),
            PEFTConfig(method="ether", n_blocks=8, targets=peft_targets(arch)))


@functools.lru_cache(maxsize=None)
def _served(arch):
    """JAX and port prefill logits and greedy decode on one smoke model."""
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = jpeft.init_adapters(jax.random.PRNGKey(1), params, jp)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, P)).astype(
        np.int32)
    jpf = jax.jit(japi.prefill, static_argnums=(3, 4))
    jst = jax.jit(japi.decode_step, static_argnums=(4, 5))
    jcache, jlog = jpf(params, adapters, {"tokens": jnp.asarray(tokens)},
                       cfg, jp)
    c = japi.pad_cache(jcache, cfg, P + GEN + 1)
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    jsteps, jtoks = [], [np.asarray(tok)]
    for _ in range(GEN):
        lg, c = jst(params, adapters, c, tok, cfg, jp)
        jsteps.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        jtoks.append(np.asarray(tok))

    tparams = bridge.to_torch(_np_tree(params))
    tadapters = bridge.to_torch(_np_tree(adapters))
    execute.reset_counters()
    tcache, tlog = api.prefill(tparams, tadapters,
                               {"tokens": torch.from_numpy(tokens).long()},
                               tcfg, tp)
    calls = execute.counters()
    c = api.pad_cache(tcache, tcfg, P + GEN + 1)
    tsteps, ttoks = [], [tlog[:, -1].argmax(-1, keepdim=True).numpy()]
    for i in range(GEN):
        lg, c = api.decode_step(tparams, tadapters, c,
                                torch.from_numpy(np.array(jtoks[i])).long(),
                                tcfg, tp)
        tsteps.append(lg.numpy())
        ttoks.append(lg[:, -1].argmax(-1, keepdim=True).numpy())
    return dict(tcfg=tcfg, params=params, tparams=tparams, jlog=jlog,
                tlog=tlog, jsteps=jsteps, tsteps=tsteps, jtoks=jtoks,
                ttoks=ttoks, calls=calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch):
    r = _served(arch)
    cfg = r["tcfg"]
    assert r["tlog"].shape == (B, 1, cfg.vocab)
    assert _max_err(r["tlog"], r["jlog"]) < F32_TOL
    for t_lg, j_lg in zip(r["tsteps"], r["jsteps"]):
        assert _max_err(t_lg, j_lg) < F32_TOL
    np.testing.assert_array_equal(np.concatenate(r["ttoks"], 1),
                                  np.concatenate(r["jtoks"], 1))
    assert r["calls"] == {"householder_gemm.torch": 7 * cfg.n_layers,
                          "flash_attention.torch": cfg.n_layers}


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-coder-33b"])
def test_untied_head_is_the_bridged_lm_head(arch):
    r = _served(arch)
    head = r["tparams"]["lm_head"]["kernel"]
    np.testing.assert_array_equal(head.numpy(),
                                  np.asarray(r["params"]["lm_head"]["kernel"]))
    hidden = torch.randn(2, 1, r["tcfg"].d_model,
                         generator=torch.Generator().manual_seed(0))
    from repro_torch.models import backbone
    np.testing.assert_allclose(
        backbone.logits_fn(r["tparams"], r["tcfg"], hidden).numpy(),
        (hidden @ head).numpy(), rtol=1e-6, atol=1e-6)
    # the tied table is not the head
    assert r["tparams"]["embed"]["table"].shape == head.T.shape
    assert not torch.allclose(r["tparams"]["embed"]["table"], head.T)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_adapter_grads_match_jax(arch):
    cfg, tcfg = jget_config(arch, "smoke"), get_config(arch, "smoke")
    jp, tp = _peft_pair(arch)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = jpeft.init_adapters(jax.random.PRNGKey(1), params, jp)
    batch = JStream(vocab=cfg.vocab, batch=B, seq_len=S_TRAIN,
                    seed=3).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a, b: japi.train_loss(params, a, b, cfg, jp), has_aux=True))(
        adapters, {k: jnp.asarray(v) for k, v in batch.items()})

    tparams = bridge.to_torch(_np_tree(params))
    tadapters = bridge.to_torch(_np_tree(adapters))
    leaves = flatten_with_paths(tadapters)
    for _, leaf in leaves:
        leaf.requires_grad_()
    execute.reset_counters()
    tloss, _ = api.train_loss(tparams, tadapters,
                              {k: torch.from_numpy(v).long()
                               for k, v in batch.items()}, tcfg, tp)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) / float(jloss) < F32_TOL
    jg = dict(jflatten(jgrads))
    for path, leaf in leaves:
        assert _max_err(_np(leaf.grad), jg[path]) < GRAD_TOL, path
    # training attends in plain autograd, on the torch route: once a
    # layer (the smoke configs do not rematerialise)
    per_pass = 7 * tcfg.n_layers
    assert execute.counters() == {"householder_gemm.torch": per_pass,
                                  "householder_gemm_bwd.torch": per_pass,
                                  "flash_attention.torch": tcfg.n_layers}


def test_checkpoint_round_trip_keeps_the_untied_head(tmp_path):
    params = _served("qwen2.5-32b")["tparams"]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params, block=True)
    mgr.close()
    mgr = CheckpointManager(str(tmp_path))
    back, _ = mgr.restore(template=params)
    mgr.close()
    got = dict(flatten_with_paths(back))
    assert "lm_head/kernel" in got
    for path, leaf in flatten_with_paths(params):
        assert torch.equal(got[path], leaf), path


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "minicpm-2b"])
def test_serve_cli_runs_the_dense_decoders_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "2"])
    assert tuple(res["tokens"].shape) == (2, 3)
    out = capsys.readouterr().out
    assert "flash_attention.torch" in out
