"""The port's Mamba-2 serving slice held against the JAX package on the
CPU, at the Mamba-2 smoke size (3 layers, d 64, headdim 16, state 16,
chunk 8, float32), on inputs made from numpy seeds:

* the plain ``ref_ssd_chunk`` (the SSD kernel's plain version) against
  ``ssd_chunk_pallas`` in interpret mode, and ``ops.ssd_chunk`` on CPU
  tensors against it;
* ``models.ssm.ssd_chunked`` with its chunks on the plain version and on
  the kernel's wrapper ``ops.ssd_chunk`` (the ``torch`` and ``cuda``
  routes of its dispatch) against the JAX ``models.ssm.ssd_chunked``,
  with S not a multiple of the chunk and a nonzero initial state, and
  against the sequential oracle ``ref_ssd_chunk_scan`` of both packages;
* ``mamba2_block`` prefill and decode on bridged weights;
* whole-model prefill plus greedy decode for ETHER, ETHER+, DeLoRA and
  HyperAdapt, unmerged, merged and from a 4-tenant bank, the adapters
  moved off their identity init;
* right-padded prefill with ``true_lens`` against the unpadded prompt;
* the configs, the bridge, the serve CLI and the refusal to train.

Tolerances: the ops ≤ 1e-5 normalised max error (max|a − b| / max|b|),
float32 sums in another order; logits ≤ 3e-5 relative Frobenius, three
layers of such sums (the dense decoders' tests measured up to 1.44e-5).
"""

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
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import api as japi
from repro.models import ssm as jssm
from repro_torch import NotPortedError, bridge
from repro_torch.common.pytree import flatten_with_paths, map_with_paths
from repro_torch.configs import get_config, peft_targets
from repro_torch.core import execute, peft
from repro_torch.core.transforms import PEFTConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, steps, train
from repro_torch.models import api, backbone, ssm
from repro_torch.optim import adamw, constant

ARCH = "mamba2-1.3b"
METHODS = ["ether", "etherplus", "delora", "hyperadapt"]
OP_TOL = 1e-5
LOGIT_TOL = 3e-5
B, P, GEN, TENANTS = 2, 13, 3, 4
# each adapter moved off its method's identity (ETHER's random u is none)
_SPREAD = {("etherplus", "v1"): 0.5, ("etherplus", "v2"): 0.5,
           ("delora", "b"): 0.5, ("delora", "lam"): 2.0,
           ("hyperadapt", "r"): 0.2, ("hyperadapt", "c"): 0.2}


def _max_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _frob(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ssd_inputs(seed, b, s, h, p, g, n, decay=1.0):
    """xv, a (log-decay −decay·softplus(N(0, 1))), b, c and an initial
    state, float32 numpy."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    a = -decay * np.log1p(np.exp(draw(b, s, h)))
    return dict(xv=draw(b, s, h, p), a=a.astype(np.float32),
                b=0.5 * draw(b, s, g, n), c=0.5 * draw(b, s, g, n),
                init=draw(b, h, n, p))


def _torch(k, *names):
    return [torch.from_numpy(k[nm]) for nm in names]


# ---------------------------------------------------------------------------
# The SSD ops
# ---------------------------------------------------------------------------

# (B, S, H, P, G, N, L): the smoke mixer's widths at chunk 8, two groups,
# one chunk, a long chunk, an odd chunk
CHUNK_SHAPES = [(2, 16, 8, 16, 1, 16, 8), (1, 24, 4, 8, 2, 6, 8),
                (2, 32, 2, 16, 1, 8, 32), (1, 15, 3, 5, 3, 7, 5)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CHUNK_SHAPES)
def test_ssd_chunk_plain_matches_the_pallas_kernel(b, s, h, p, g, n, chunk):
    k = _ssd_inputs(0, b, s, h, p, g, n)
    xv, a, bb, cc = _torch(k, "xv", "a", "b", "c")
    y, states, decays = ref.ref_ssd_chunk(xv, a, bb, cc, chunk)
    nc = s // chunk
    assert (y.shape, states.shape, decays.shape) == (
        (b, s, h, p), (b, h, nc, n, p), (b, h, nc))
    assert y.dtype == states.dtype == decays.dtype == torch.float32
    # the Pallas kernel's (BH, S, ·) operands, b and c copied to every head
    rep = h // g
    fold = lambda t: np.moveaxis(t, 2, 1).reshape(b * h, s, *t.shape[3:])
    jy, jst, jdec = ssd_chunk_pallas(
        jnp.asarray(fold(k["xv"])), jnp.asarray(fold(k["a"])),
        jnp.asarray(fold(np.repeat(k["b"], rep, axis=2))),
        jnp.asarray(fold(np.repeat(k["c"], rep, axis=2))), chunk=chunk,
        interpret=True)
    assert _max_err(fold(y.numpy()), jy) < OP_TOL
    assert _max_err(states.reshape(b * h, nc, n, p), jst) < OP_TOL
    assert _max_err(decays.reshape(b * h, nc), jdec) < OP_TOL
    # the wrapper on CPU tensors is its plain version, no launch
    ops.reset_launches()
    got = ops.ssd_chunk(xv, a, bb, cc, chunk)
    assert all(torch.equal(u, v) for u, v in zip(got, (y, states, decays)))
    assert ops.launches()["ssd_chunk"] == 0


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(2, 21, 8, 16, 1, 16, 8),
                                               (1, 30, 4, 8, 2, 6, 8),
                                               (2, 5, 4, 16, 1, 16, 8)])
def test_ssd_chunked_matches_jax(b, s, h, p, g, n, chunk, with_init):
    k = _ssd_inputs(1, b, s, h, p, g, n)
    xv, a, bb, cc, init = _torch(k, "xv", "a", "b", "c", "init")
    init = init if with_init else None
    jy, jfinal = jssm.ssd_chunked(
        jnp.asarray(k["xv"]), jnp.asarray(k["a"]), jnp.asarray(k["b"]),
        jnp.asarray(k["c"]), chunk=chunk,
        initial_state=jnp.asarray(k["init"]) if with_init else None)
    for intra in (ref.ref_ssd_chunk, ops.ssd_chunk):
        y, final = ssm.ssd_chunked(xv, a, bb, cc, chunk=chunk,
                                   initial_state=init, intra=intra)
        assert y.shape == (b, s, h, p) and final.shape == (b, h, n, p)
        assert _max_err(y, jy) < OP_TOL, intra.__module__
        assert _max_err(final, jfinal) < OP_TOL, intra.__module__


@pytest.mark.parametrize("decay", [0.0, 1.0, 30.0])
def test_ssd_chunked_matches_the_sequential_oracle(decay):
    """Both chunked forms against the step-by-step recurrence of both
    packages, from a pass-through (a = 0) to strong decay."""
    k = _ssd_inputs(2, 2, 19, 4, 8, 2, 6, decay)
    xv, a, bb, cc = _torch(k, "xv", "a", "b", "c")
    want = jref.ref_ssd_chunk_scan(*(jnp.asarray(k[nm])
                                     for nm in ("xv", "a", "b", "c")),
                                   chunk=8)
    oracle = ref.ref_ssd_chunk_scan(xv, a, bb, cc)
    assert _max_err(oracle, want) < OP_TOL
    for intra in (ref.ref_ssd_chunk, ops.ssd_chunk):
        y, _ = ssm.ssd_chunked(xv, a, bb, cc, chunk=8, intra=intra)
        assert _max_err(y, want) < OP_TOL, intra.__module__


def test_ssd_wrappers_refuse_what_the_kernel_does_not_take():
    k = _ssd_inputs(3, 1, 16, 4, 8, 2, 6)
    xv, a, bb, cc = _torch(k, "xv", "a", "b", "c")
    cases = [((xv, a, bb, cc, 5), "multiple of chunk"),
             ((xv, a, bb, cc, 512), "chunk must lie"),
             ((xv.double(), a, bb, cc, 8), "float32 \\(B, S, H, P\\)"),
             ((xv, a, bb[:, :, :1].repeat(1, 1, 3, 1), cc, 8), "one dtype"),
             ((xv, a, bb.half(), cc.half(), 8), "one dtype"),
             ((xv, a[..., :3], bb, cc, 8), "a must be"),
             ((xv.transpose(1, 2).contiguous().transpose(1, 2), a, bb, cc,
               8), "contiguous")]
    for args, why in cases:
        with pytest.raises(ops.KernelInputError, match=why):
            ops.ssd_chunk(*args)
    g3 = torch.zeros(1, 16, 3, 6)
    with pytest.raises(ops.KernelInputError, match="H % G"):
        ops.ssd_chunk(xv, a, g3, g3, 8)
    with pytest.raises(ValueError, match="initial_state"):
        ssm.ssd_chunked(xv, a, bb, cc, chunk=8, intra=ops.ssd_chunk,
                        initial_state=torch.zeros(1, 4, 6, 7))
    wide = torch.zeros(1, 16, 2, 257)
    with pytest.raises(ops.KernelInputError, match="N ≤ 256"):
        ops.ssd_chunk(xv, a, wide, wide, 8)


# ---------------------------------------------------------------------------
# The block, the model and serving
# ---------------------------------------------------------------------------

def _peft_pair(method):
    return (JPEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                        targets=jpeft_targets(ARCH), backend="jnp"),
            PEFTConfig(method=method, n_blocks=8, rank=8, alpha=8.0,
                       targets=peft_targets(ARCH)))


def _adapters(params, jp, method, seed):
    tree = jpeft.init_adapters(jax.random.PRNGKey(100 + seed), params, jp)
    rng = np.random.default_rng(1000 + seed)

    def move(path, leaf):
        sd = _SPREAD.get((method, path[-1].key))
        if sd is None:
            return leaf
        return leaf + sd * jnp.asarray(rng.standard_normal(leaf.shape),
                                       leaf.dtype)
    return jax.tree_util.tree_map_with_path(move, tree)


@functools.lru_cache(maxsize=None)
def _model():
    cfg = jget_config(ARCH, "smoke")
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    return cfg, params, bridge.to_torch(_np_tree(params))


def test_mamba2_block_prefill_and_decode_match_jax():
    cfg, params, tparams = _model()
    jp, tp = _peft_pair("ether")
    jad = _adapters(params, jp, "ether", 0)
    tad = bridge.to_torch(_np_tree(jad))
    take = lambda tree: jax.tree_util.tree_map(lambda v: v[0], tree)
    p, a = take(params["units"]["pos0"]["mixer"]), take(
        jad["units"]["pos0"]["mixer"])
    tp_, ta = (tparams["units"]["pos0"]["mixer"],
               tad["units"]["pos0"]["mixer"])
    tp_ = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0]
                                                 for kk, vv in v.items()})
           for k, v in tp_.items()}
    ta = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in ta.items()}
    kw = dict(d_model=cfg.d_model, chunk=cfg.ssm_chunk,
              expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
              d_state=cfg.ssm_state, n_groups=cfg.ssm_groups)
    x = np.random.default_rng(4).standard_normal((B, 11, cfg.d_model)
                                                 ).astype(np.float32)
    block = jax.jit(functools.partial(jssm.mamba2_block, peft=jp, **kw))
    jout, jcache = block(p, jnp.asarray(x), adapters=a)
    tout, tcache = ssm.mamba2_block(tp_, torch.from_numpy(x), adapters=ta,
                                    peft=tp, **kw)
    assert _max_err(tout, jout) < OP_TOL
    for key in ("conv", "ssm"):
        assert tcache[key].dtype == torch.float32
        assert _max_err(tcache[key], jcache[key]) < OP_TOL, key
    x1 = x[:, :1] * 0.5
    jout, jcache = block(p, jnp.asarray(x1), cache=jcache, adapters=a)
    tout, tcache = ssm.mamba2_block(tp_, torch.from_numpy(x1), cache=tcache,
                                    adapters=ta, peft=tp, **kw)
    assert _max_err(tout, jout) < OP_TOL
    assert _max_err(tcache["ssm"], jcache["ssm"]) < OP_TOL


def _greedy_np(logits):
    return np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)


def _serve_jax(params, adapters, tokens, cfg, jp, tenant_ids=None):
    pf = jax.jit(japi.prefill, static_argnums=(3, 4))
    st = jax.jit(japi.decode_step, static_argnums=(4, 5))
    kw = {} if tenant_ids is None else {"tenant_ids": jnp.asarray(tenant_ids)}
    cache, lg = pf(params, adapters, {"tokens": jnp.asarray(tokens)}, cfg,
                   jp, **kw)
    cache = japi.pad_cache(cache, cfg, tokens.shape[1] + GEN + 1)
    out, toks = [np.asarray(lg)], [_greedy_np(lg)]
    for _ in range(GEN):
        lg, cache = st(params, adapters, cache, jnp.asarray(toks[-1]), cfg,
                       jp, **kw)
        out.append(np.asarray(lg))
        toks.append(_greedy_np(lg))
    return out, toks


def _serve_port(params, adapters, tokens, cfg, tp, toks, tenant_ids=None):
    """Prefill and GEN decode steps fed JAX's greedy tokens ``toks``."""
    kw = {} if tenant_ids is None else {
        "tenant_ids": torch.from_numpy(tenant_ids)}
    cache, lg = api.prefill(params, adapters,
                            {"tokens": torch.from_numpy(tokens).long()},
                            cfg, tp, **kw)
    cache = api.pad_cache(cache, cfg, tokens.shape[1] + GEN + 1)
    out = [lg.numpy()]
    for i in range(GEN):
        lg, cache = api.decode_step(params, adapters, cache,
                                    torch.from_numpy(toks[i]).long(), cfg,
                                    tp, **kw)
        out.append(lg.numpy())
    return out, cache


@pytest.mark.parametrize("mode", ["unmerged", "merged", "bank"])
@pytest.mark.parametrize("method", METHODS)
def test_mamba2_serving_matches_jax(method, mode):
    cfg, params, tparams = _model()
    tcfg = get_config(ARCH, "smoke")
    jp, tp = _peft_pair(method)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, P)
                                               ).astype(np.int32)
    ids = None
    if mode == "bank":
        trees = [_adapters(params, jp, method, t) for t in range(TENANTS)]
        jad = jpeft.AdapterBank.stack(trees, params, jp)
        tad = bridge.bank_to_torch(jad)
        ids = np.array([TENANTS - 1, 1], np.int32)
    else:
        jad = _adapters(params, jp, method, 0)
        tad = bridge.to_torch(_np_tree(jad))
    jparams, tparams_ = params, tparams
    if mode == "merged":
        jparams = jpeft.merge_params(params, jad, jp)
        tparams_ = peft.merge_params(tparams, tad, tp)
        jad = tad = jp = tp = None
    want, toks = _serve_jax(jparams, jad, tokens, cfg, jp, ids)
    execute.reset_counters()
    got, cache = _serve_port(tparams_, tad, tokens, tcfg, tp, toks, ids)
    # the chunked scan ran once a layer in the prefill, on the plain path
    assert execute.counters()["ssd_chunked.torch"] == cfg.n_layers
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, 1, cfg.vocab)
        assert _frob(g, w) < LOGIT_TOL, f"step {step}"
    # the adapters matter: the base model's logits are further away
    if mode != "merged":
        _, base = api.prefill(tparams, None,
                              {"tokens": torch.from_numpy(tokens).long()},
                              tcfg, None)
        assert _frob(base.numpy(), want[0]) > 100 * LOGIT_TOL


def test_mamba2_right_padded_prefill_matches_the_unpadded_prompt():
    cfg, params, tparams = _model()
    tcfg = get_config(ARCH, "smoke")
    jp, tp = _peft_pair("ether")
    jad = _adapters(params, jp, "ether", 0)
    tad = bridge.to_torch(_np_tree(jad))
    rng = np.random.default_rng(6)
    lens = np.array([P, 5, 2], np.int32)        # one chunk and a bit, < W−1
    tokens = rng.integers(0, cfg.vocab, (3, P)).astype(np.int32)
    padded = tokens.copy()
    for r, n in enumerate(lens):
        padded[r, n:] = rng.integers(0, cfg.vocab, P - n)   # junk pads
    cache, lg = api.prefill(tparams, tad,
                            {"tokens": torch.from_numpy(padded).long()},
                            tcfg, tp, true_lens=lens)
    _, jlg = japi.prefill(params, jad, {"tokens": jnp.asarray(padded)}, cfg,
                          jp, true_lens=lens)
    assert _frob(lg.numpy(), jlg) < LOGIT_TOL
    singles = []
    for r, n in enumerate(lens):
        one = torch.from_numpy(tokens[r:r + 1, :n]).long()
        c1, l1 = api.prefill(tparams, tad, {"tokens": one}, tcfg, tp)
        assert _frob(lg[r:r + 1].numpy(), l1.numpy()) < LOGIT_TOL
        for key in ("conv", "ssm"):
            assert _max_err(cache["pos0"][key][:, r:r + 1],
                            c1["pos0"][key]) < OP_TOL, (r, key)
        singles.append(c1)
    # decode replaces the state in place, so it comes after the checks
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1))).long()
    dlg, _ = api.decode_step(tparams, tad, api.pad_cache(cache, tcfg, P + 2),
                             nxt, tcfg, tp)
    for r, c1 in enumerate(singles):
        d1, _ = api.decode_step(tparams, tad, c1, nxt[r:r + 1], tcfg, tp)
        assert _frob(dlg[r:r + 1].numpy(), d1.numpy()) < LOGIT_TOL


def test_mamba2_cache_layout_and_pad_cache():
    tcfg = get_config(ARCH, "smoke")
    params = api.init_model(tcfg, seed=0, device="cpu")
    cache = backbone.init_cache(tcfg, 2, 50, "cpu")
    d = ssm.ssm_dims(tcfg.d_model, headdim=tcfg.ssm_headdim,
                     d_state=tcfg.ssm_state)
    conv_ch = d["d_inner"] + 2 * d["n_groups"] * d["d_state"]
    assert cache["pos0"]["conv"].shape == (3, 2, 3, conv_ch)
    assert cache["pos0"]["conv"].dtype == tcfg.cdt()
    assert cache["pos0"]["ssm"].shape == (3, 2, d["n_heads"], 16, 16)
    assert cache["pos0"]["ssm"].dtype == torch.float32
    tokens = torch.randint(0, tcfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    pre, _ = api.prefill(params, None, {"tokens": tokens}, tcfg, None)
    assert {k: v.shape for k, v in pre["pos0"].items()} == {
        k: v.shape for k, v in cache["pos0"].items()}
    assert api.pad_cache(pre, tcfg, 64) is pre      # fixed-size already
    with pytest.raises(ValueError, match="only applies to prefill"):
        backbone.forward(params, tcfg, tokens=tokens, mode="decode",
                         cache=pre, true_lens=torch.tensor([9, 9]))


# ---------------------------------------------------------------------------
# Configs, params, the bridge, PEFT targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_mamba2_config_fields_equal_jax(variant):
    assert (dataclasses.asdict(get_config(ARCH, variant))
            == dataclasses.asdict(jget_config(ARCH, variant)))
    assert get_config("mamba2_1p3b", variant) == get_config(ARCH, variant)
    assert peft_targets(ARCH) == jpeft_targets(ARCH) == "in_proj|out_proj"


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_mamba2_adapters_target_in_and_out_proj(variant, method):
    """The port's params have the JAX package's paths, shapes and dtypes;
    adapters go on in_proj and out_proj only (conv, Δ, A, D frozen), with
    the JAX package's counts."""
    cfg = jget_config(ARCH, variant)
    shapes = jax.eval_shape(lambda k: japi.init_model(k, cfg),
                            jax.random.PRNGKey(0))
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)
    jp, tp = _peft_pair(method)
    assert (peft.adapters_param_count(meta, tp)
            == jpeft.adapters_param_count(shapes, jp))
    if variant == "smoke":
        tparams = api.init_model(get_config(ARCH, variant), seed=0,
                                 device="cpu")
        want = {p: (tuple(s.shape), str(s.dtype)) for p, s in
                flatten_with_paths(shapes)}
        assert {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in
                flatten_with_paths(tparams)} == want
        gen = torch.Generator().manual_seed(1)
        ad = peft.init_adapters(gen, tparams, tp)
        # off the identity init (DeLoRA's b = 0, HyperAdapt's r = c = 1)
        ad = map_with_paths(lambda _, t: t + 0.1 * torch.randn(
            t.shape, generator=gen), ad)
        mods = {p.rsplit("/", 1)[0] for p, _ in flatten_with_paths(ad)}
        assert mods == {"units/pos0/mixer/in_proj",
                        "units/pos0/mixer/out_proj"}
        merged = peft.merge_params(tparams, ad, tp)
        for p, t in flatten_with_paths(tparams):
            same = torch.equal(dict(flatten_with_paths(merged))[p], t)
            assert same != p.endswith(("in_proj/kernel", "out_proj/kernel")), p
        bank = peft.init_adapter_bank(2, tparams, tp, 3)
        assert set(bank.stack_ndims) == mods


def test_the_bridge_carries_a_mamba2_param_tree_unchanged():
    cfg = dataclasses.replace(jget_config(ARCH, "smoke"),
                              param_dtype="bfloat16")
    params = _np_tree(japi.init_model(jax.random.PRNGKey(3), cfg))
    tparams = bridge.to_torch(params)
    want = dict(flatten_with_paths(params))
    got = dict(flatten_with_paths(tparams))
    assert set(got) == set(want)
    mixer = "units/pos0/mixer/"
    for name in ("a_log", "dt_bias", "d_skip"):
        assert got[mixer + name].dtype == torch.float32
    assert got[mixer + "conv/kernel"].dtype == torch.bfloat16
    assert got[mixer + "conv/kernel"].shape == (3, 4, 128 + 2 * 16)
    for p, t in got.items():
        assert tuple(t.shape) == want[p].shape, p
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(want[p], np.float32), p)


# ---------------------------------------------------------------------------
# The CLI, and training refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--merged"], ["--tenants", "3"],
                                   ["--method", "delora", "--merged"]])
def test_serve_cli_serves_mamba2_on_the_cpu(flags, capsys):
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--prompt-len", "11", "--gen", "2", *flags])
    out = capsys.readouterr().out
    assert "ssd_chunked.torch" in out
    runs = [res["bank"], res["merged"]] if "--tenants" in flags else [res]
    for r in runs:
        assert r["tokens"].shape == (2, 3)
        assert torch.isfinite(r["logits"]).all()


def test_training_a_mamba2_config_raises_not_ported():
    cfg = get_config(ARCH, "smoke")
    tp = PEFTConfig(targets=peft_targets(ARCH))
    params = api.init_model(cfg, seed=0, device="cpu")
    ad = peft.init_adapters(torch.Generator().manual_seed(1), params, tp)
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.long),
             "labels": torch.zeros(1, 8, dtype=torch.long)}
    opt = adamw(constant(1e-3))
    with pytest.raises(NotPortedError, match="'ssd'"):
        api.train_loss(params, ad, batch, cfg, tp)
    with pytest.raises(NotPortedError, match="'ssd'"):
        steps.make_train_step(cfg, tp, opt)
    with pytest.raises(NotPortedError, match="'ssd'"):
        steps.make_bank_train_step(cfg, tp, opt,
                                   peft.init_adapter_bank(0, params, tp, 2))
    with pytest.raises(NotPortedError, match="'ssd'"):
        train.main(["--device", "cpu", "--arch", ARCH, "--steps", "1"])
