"""The port's serving slice held against the JAX package on the same
weights: JAX builds params and adapters, ``repro_torch.bridge`` carries
them across as numpy, and both sides prefill and decode the same numpy
prompts on the CPU (the port through its plain versions)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import peft_targets as jpeft_targets
from repro.core import peft as jpeft
from repro.core.transforms import PEFTConfig as JPEFTConfig
from repro.models import api as japi
from repro_torch import bridge
from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute, peft
from repro_torch.core.transforms import PEFTConfig
from repro_torch.models import api

ARCHS = ["smollm-360m", "llama-2-7b"]
B, P, GEN = 2, 8, 4
# float32 end to end: four layers of sums taken in another order and
# XLA's vs PyTorch's exp/sin/cos (about 2e-6 seen); normalised max error
# max|a−b|/max|b|
F32_TOL = 1e-5


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _run(arch):
    """JAX and port results on one smoke model; cached per arch."""
    cfg = jget_config(arch, "smoke")
    jp = JPEFTConfig(method="ether", n_blocks=8,
                     targets=jpeft_targets(arch), backend="jnp")
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    adapters = jpeft.init_adapters(jax.random.PRNGKey(1), params, jp)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    true_lens = np.array([P, P - 3], np.int32)

    jpf = jax.jit(japi.prefill, static_argnums=(3, 4))
    jst = jax.jit(japi.decode_step, static_argnums=(4, 5))
    jcache, jlog = jpf(params, adapters, {"tokens": jnp.asarray(tokens)},
                       cfg, jp)
    _, jlog_tl = japi.prefill(params, adapters,
                              {"tokens": jnp.asarray(tokens)}, cfg, jp,
                              true_lens=true_lens)
    c = japi.pad_cache(jcache, cfg, P + GEN + 1)
    tok = jnp.argmax(jlog[:, -1], -1)[:, None].astype(jnp.int32)
    jsteps, jtoks = [], [np.asarray(tok)]
    for _ in range(GEN):
        lg, c = jst(params, adapters, c, tok, cfg, jp)
        jsteps.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        jtoks.append(np.asarray(tok))

    tcfg = get_config(arch, "smoke")
    tp = PEFTConfig(method="ether", n_blocks=8, targets=peft_targets(arch))
    tparams = bridge.to_torch(_np_tree(params))
    tadapters = bridge.to_torch(_np_tree(adapters))
    ttok = torch.from_numpy(tokens).long()
    execute.reset_counters()
    tcache, tlog = api.prefill(tparams, tadapters, {"tokens": ttok}, tcfg, tp)
    _, tlog_tl = api.prefill(tparams, tadapters, {"tokens": ttok}, tcfg, tp,
                             true_lens=true_lens)
    prefill_calls = execute.counters()
    c = api.pad_cache(tcache, tcfg, P + GEN + 1)
    # decode on JAX's greedy tokens, so each step compares like with like
    tsteps, ttoks = [], [tlog[:, -1].argmax(-1, keepdim=True).numpy()]
    for i in range(GEN):
        tok_i = torch.from_numpy(np.array(jtoks[i])).long()
        lg, c = api.decode_step(tparams, tadapters, c, tok_i, tcfg, tp)
        tsteps.append(lg.numpy())
        ttoks.append(lg[:, -1].argmax(-1, keepdim=True).numpy())

    merged = peft.merge_params(tparams, tadapters, tp)
    _, mlog = api.prefill(merged, None, {"tokens": ttok}, tcfg, None)
    return dict(cfg=cfg, jcache=jcache, jlog=jlog, jlog_tl=jlog_tl,
                jsteps=jsteps, jtoks=jtoks, tcache=tcache, tlog=tlog,
                tlog_tl=tlog_tl, tsteps=tsteps, ttoks=ttoks, mlog=mlog,
                prefill_calls=prefill_calls)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_model_config_fields_equal(arch, variant):
    assert (dataclasses.asdict(get_config(arch, variant))
            == dataclasses.asdict(jget_config(arch, variant)))
    assert peft_targets(arch) == jpeft_targets(arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("n_blocks", [8, 32])
def test_adapter_param_count_equal(arch, variant, n_blocks):
    cfg = jget_config(arch, variant)
    shapes = jax.eval_shape(lambda k: japi.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)
    jp = JPEFTConfig(n_blocks=n_blocks, targets=jpeft_targets(arch))
    tp = PEFTConfig(n_blocks=n_blocks, targets=peft_targets(arch))
    assert (peft.adapters_param_count(meta, tp)
            == jpeft.adapters_param_count(shapes, jp))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    r = _run(arch)
    cfg = r["cfg"]
    assert r["tlog"].shape == (B, 1, cfg.vocab)
    assert r["tlog"].dtype == torch.float32
    assert _max_err(r["tlog"], r["jlog"]) < F32_TOL
    assert _max_err(r["tlog_tl"], r["jlog_tl"]) < F32_TOL
    assert r["tcache"]["cursor"] == int(r["jcache"]["cursor"]) == P
    for kv in ("k", "v"):
        assert (tuple(r["tcache"]["pos0"][kv].shape)
                == r["jcache"]["pos0"][kv].shape)
        assert _max_err(r["tcache"]["pos0"][kv],
                        r["jcache"]["pos0"][kv]) < F32_TOL
    # every adapted linear of every layer went through householder_gemm,
    # every layer's attention through the flash_attention dispatch
    assert r["prefill_calls"] == {"householder_gemm.torch":
                                  2 * 7 * cfg.n_layers,
                                  "flash_attention.torch": 2 * cfg.n_layers}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_and_greedy_tokens_match_jax(arch):
    r = _run(arch)
    assert len(r["tsteps"]) == GEN >= 4
    for t_lg, j_lg in zip(r["tsteps"], r["jsteps"]):
        assert _max_err(t_lg, j_lg) < F32_TOL
    np.testing.assert_array_equal(np.concatenate(r["ttoks"], 1),
                                  np.concatenate(r["jtoks"], 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_merged_matches_unmerged(arch):
    r = _run(arch)
    assert _max_err(r["mlog"], r["tlog"]) < F32_TOL
    assert _max_err(r["mlog"], r["jlog"]) < F32_TOL


def test_validate_true_lens_refuses_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        api.validate_true_lens([0, 3], 8)
    with pytest.raises(ValueError, match="out of range"):
        api.validate_true_lens(torch.tensor([9]), 8)
    np.testing.assert_array_equal(api.validate_true_lens([1, 8], 8), [1, 8])


@pytest.mark.parametrize("heads", [True, False])
def test_rope_and_rmsnorm_match_jax(heads):
    from repro.models import layers as jL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(1)
    shape = (2, 5, 3, 16) if heads else (2, 5, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, 12), (2, 5)).astype(np.int32)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos).long())
    assert _max_err(got, jL.rope(jnp.asarray(x), jnp.asarray(pos))) < F32_TOL
    scale = rng.standard_normal(16).astype(np.float32)
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    assert _max_err(got, want) < F32_TOL
