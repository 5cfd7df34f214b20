"""PEFT method registry of the port.

Every finetuning transform is a :class:`PEFTMethod`: adapter factory
(``init``), adapted forward (``dense``), multi-tenant bank forward
(``bank_dense``), absorption (``merge``), parameter accounting and the
identity adapter values (``identity_leaf``).  The port has the JAX
registry's methods in its order but VeRA: ETHER, ETHER+, OFT, Naive,
LoRA, full finetuning, DeLoRA and HyperAdapt.  :func:`get` raises
:class:`repro_torch.NotPortedError` for VeRA and the JAX package's
:class:`UnknownMethodError` for a name neither registry has.  ``dense``
follows ``cfg.mode`` as the JAX methods do: ``activation`` runs the
fused kernels, ``weight`` computes ``x @ merge(W)`` (the merge kernels,
differentiated through their autograd Functions), ``blockgemm`` the
paper-literal block GEMMs in plain PyTorch; ``merge(..., literal=True)``
and ``materialize`` build the dense blocks.  The methods flagged
``bank_servable`` (ETHER, ETHER+, DeLoRA, HyperAdapt, as in the JAX
registry) serve an
:class:`~repro_torch.core.peft.AdapterBank` through their batched
kernels; ``bank_dense`` of any other method raises the JAX package's
ValueError.  The kernel ops (ETHER, ETHER+, DeLoRA, HyperAdapt) dispatch
through :mod:`repro_torch.core.execute`; OFT, Naive, LoRA and ``full``
are plain PyTorch, as the JAX package runs them in jnp.
"""

from __future__ import annotations

from typing import Any

import math

import torch

from repro_torch import NotPortedError
from repro_torch.common.dtypes import torch_dtype
from repro_torch.core import execute

Params = dict[str, Any]

_METHOD_REGISTRY: dict[str, "PEFTMethod"] = {}
_EPS = 1e-8     # DeLoRA's scale: ε beside the norms' product, as in JAX
# the JAX registry's methods that the port has not ported (ROADMAP.md)
UNPORTED = ("vera",)


class UnknownMethodError(ValueError):
    """A method name in neither registry; carries the valid names, with
    the JAX package's message."""

    def __init__(self, name):
        self.name = name
        self.valid = available()
        super().__init__(f"unknown PEFT method {name!r}; valid methods: "
                         f"{', '.join(self.valid)}")


def register_method(cls):
    """Class decorator: add one instance of ``cls`` to the registry."""
    inst = cls()
    _METHOD_REGISTRY[inst.name] = inst
    return cls


def available() -> tuple[str, ...]:
    """Registered method names, in registration order."""
    return tuple(_METHOD_REGISTRY)


def get(name: str) -> "PEFTMethod":
    """Resolve a method name: :class:`UnknownMethodError` (a ValueError
    listing the valid names) for a name the JAX registry lacks too,
    :class:`repro_torch.NotPortedError` for one of its methods that the
    port has not ported (``UNPORTED``)."""
    try:
        return _METHOD_REGISTRY[name]
    except KeyError:
        if name in UNPORTED:
            raise NotPortedError(f"PEFT method {name!r} (ported: "
                                 f"{', '.join(available())})") from None
        raise UnknownMethodError(name) from None


def bank_servable() -> tuple[str, ...]:
    """Methods an AdapterBank can host (``bank_servable`` set)."""
    return tuple(n for n, m in _METHOD_REGISTRY.items() if m.bank_servable)


def identity_like(name: str, tree: Params) -> Params:
    """Per-method identity adapter values shaped like ``tree`` (a single
    adapter tree or a stacked one): zeros for the reflections and the
    additive methods, the identity blocks for Naive, ones for HyperAdapt's
    scales."""
    m = get(name)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else m.identity_leaf(k, v)
                for k, v in node.items()}
    return walk(tree)


def _needs_grad(*leaves) -> bool:
    """Serving (no_grad, or nothing to differentiate) calls a kernel op's
    forward itself and pays nothing for autograd."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in leaves)


def _serving_only(*leaves) -> None:
    """Bank forwards have no backward in the port yet (the batched
    backward kernels, ROADMAP Queue 2 items 14-15)."""
    if _needs_grad(*leaves):
        raise NotPortedError("training through an adapter bank")


class PEFTMethod:
    """One PEFT method; ``cfg`` is a ``transforms.PEFTConfig``.
    ``dense`` takes x with any leading dims and does not add the bias."""

    name: str = ""
    # Can an AdapterBank stack this method's adapters on a tenant axis and
    # serve each request with its own tenant's through a batched kernel?
    bank_servable: bool = False

    def bank_dense(self, x, W, adapter: Params, cfg) -> torch.Tensor:
        """The bank forward: x (B, S, d), every adapter leaf the whole bank
        (tenant axis first) and ``adapter["ids"]`` (B,) the tenant of each
        sequence."""
        raise ValueError(f"method {self.name!r} is not bank-servable "
                         f"(bank methods: {bank_servable()})")

    def identity_leaf(self, leaf_name: str, arr: torch.Tensor) -> torch.Tensor:
        """The identity adapter value of one leaf (default: zeros)."""
        return torch.zeros_like(arr)

    def init(self, generator: torch.Generator, d_in: int, d_out: int, cfg,
             stack: tuple[int, ...], device) -> Params:
        raise NotImplementedError

    def dense(self, x, W, adapter: Params, cfg) -> torch.Tensor:
        raise NotImplementedError

    def merge(self, W, adapter: Params, cfg, *,
              literal: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def materialize(self, adapter: Params, cfg, d_in: int, d_out: int):
        """(T_left, T_right): the dense transform matrices, or None each
        (small dims only: metrics and tests)."""
        return (None, None)

    def param_count(self, d_in: int, d_out: int, cfg) -> int:
        raise NotImplementedError


@register_method
class EtherMethod(PEFTMethod):
    name = "ether"
    bank_servable = True

    def init(self, generator, d_in, d_out, cfg, stack, device):
        from repro_torch.core.transforms import resolve_blocks
        n = resolve_blocks(cfg.n_blocks, d_in)
        # Random hyperplane: ETHER starts at fixed distance 2 from the
        # identity (paper Eq. 2), by design.
        return {"u": torch.randn((*stack, n, d_in // n), generator=generator,
                                 dtype=torch_dtype(cfg.adapter_dtype),
                                 device=device)}

    def dense(self, x, W, adapter, cfg):
        u = adapter["u"]
        if cfg.mode == "weight":
            return x @ self.merge(W, adapter, cfg).to(x.dtype)
        if cfg.mode == "blockgemm":                 # paper-literal §3.4
            return x @ self.merge(W, adapter, cfg, literal=True).to(x.dtype)
        if _needs_grad(x, W, u):
            return execute.HouseholderGemm.apply(x, W, u, cfg.backend)
        return execute.dispatch("householder_gemm", cfg.backend, x, W, u)

    def bank_dense(self, x, W, adapter, cfg):
        # u is the (A, n, db) bank; each sequence reflects with its own
        # tenant's hyperplanes inside the GEMM (DESIGN.md §2)
        _serving_only(x, W, adapter["u"])
        return execute.dispatch("householder_gemm_batched", cfg.backend, x,
                                W, adapter["u"], adapter["ids"])

    def merge(self, W, adapter, cfg, *, literal=False):
        from repro_torch.core import transforms as T
        u = adapter["u"]
        if literal:
            return T.block_diag_matmul(T.householder_blocks(u), W)
        if _needs_grad(W, u):
            return execute.EtherMerge.apply(W, u, cfg.backend)
        return execute.dispatch("ether_merge", cfg.backend, W, u)

    def materialize(self, adapter, cfg, d_in, d_out):
        from repro_torch.core import transforms as T
        return (T.materialize_block_diag(
            T.householder_blocks(adapter["u"])), None)

    def param_count(self, d_in, d_out, cfg):
        return d_in                                 # O(d), n-independent


@register_method
class EtherPlusMethod(PEFTMethod):
    """ETHER+: H⁺ = I − ûûᵀ + v̂v̂ᵀ per block of the input (u1, v1) and,
    two-sided (``cfg.two_sided``, the paper's default), H̃⁺ on the output
    blocks (u2, v2)."""

    name = "etherplus"
    bank_servable = True

    def init(self, generator, d_in, d_out, cfg, stack, device):
        from repro_torch.core.transforms import resolve_blocks
        dt = torch_dtype(cfg.adapter_dtype)
        n_in = resolve_blocks(cfg.n_blocks, d_in)
        u1 = torch.randn((*stack, n_in, d_in // n_in), generator=generator,
                         dtype=dt, device=device)
        out = {"u1": u1, "v1": u1.clone()}          # v = u ⇒ H⁺ = I at init
        if cfg.two_sided:
            n_out = resolve_blocks(cfg.n_blocks, d_out)
            u2 = torch.randn((*stack, n_out, d_out // n_out),
                             generator=generator, dtype=dt, device=device)
            out.update({"u2": u2, "v2": u2.clone()})
        return out

    def _pair(self, adapter, cfg):
        """(u2, v2) for a two-sided config, (None, None) one-sided.  A
        two-sided config over an adapter without u2/v2 (trained one-sided)
        is a config/checkpoint mismatch: it raises rather than serve the
        one-sided transform."""
        if not cfg.two_sided:
            return None, None
        if "u2" not in adapter or "v2" not in adapter:
            raise ValueError(
                "PEFTConfig.two_sided=True but the ETHER+ adapter has no "
                "u2/v2 leaves (trained one-sided?); set two_sided=False to "
                "serve it as-is")
        return adapter["u2"], adapter["v2"]

    def dense(self, x, W, adapter, cfg):
        if cfg.mode != "activation":
            Wt = self.merge(W, adapter, cfg,
                            literal=(cfg.mode == "blockgemm"))
            return x @ Wt.to(x.dtype)
        u1, v1 = adapter["u1"], adapter["v1"]
        u2, v2 = self._pair(adapter, cfg)
        if _needs_grad(*(t for t in (x, W, u1, v1, u2, v2)
                         if t is not None)):
            return execute.EtherPlusGemm.apply(x, W, u1, v1, u2, v2,
                                               cfg.backend)
        return execute.dispatch("etherplus_gemm", cfg.backend, x, W, u1, v1,
                                u2, v2)

    def bank_dense(self, x, W, adapter, cfg):
        # the input side's rank-2 bank update, the shared frozen product
        # (a plain matmul, as the JAX package leaves it to XLA), then,
        # two-sided, the output side's (u2/v2 banks over f)
        u2, v2 = self._pair(adapter, cfg)
        ids = adapter["ids"]
        _serving_only(x, W, adapter["u1"], adapter["v1"],
                      *(t for t in (u2, v2) if t is not None))
        xr = execute.dispatch("etherplus_reflect_batched", cfg.backend, x,
                              adapter["u1"], adapter["v1"], ids)
        y = xr @ W.to(x.dtype)
        if u2 is not None:
            y = execute.dispatch("etherplus_reflect_batched", cfg.backend, y,
                                 u2, v2, ids)
        return y

    def merge(self, W, adapter, cfg, *, literal=False):
        from repro_torch.core import transforms as T
        if literal:
            Wt = T.block_diag_matmul(self._factor(adapter, "1"), W)
            if cfg.two_sided:
                Wt = T.block_diag_matmul(self._factor(adapter, "2"), Wt,
                                         side="right")
            return Wt
        u1, v1 = adapter["u1"], adapter["v1"]
        u2, v2 = self._pair(adapter, cfg)
        if _needs_grad(*(t for t in (W, u1, v1, u2, v2) if t is not None)):
            return execute.EtherPlusMerge.apply(W, u1, v1, u2, v2,
                                                cfg.backend)
        return execute.dispatch("etherplus_merge", cfg.backend, W, u1, v1,
                                u2, v2)

    @staticmethod
    def _factor(adapter, side):
        """The dense H⁺ blocks (n, db, db) of one side ("1": input, "2":
        output): (I − ûûᵀ) + (I + v̂v̂ᵀ) − I."""
        from repro_torch.core import transforms as T
        return T._addmul((
            T.householder_blocks(adapter["u" + side], coeff=1.0, sign=-1.0),
            T.householder_blocks(adapter["v" + side], coeff=1.0, sign=1.0)))

    def materialize(self, adapter, cfg, d_in, d_out):
        from repro_torch.core import transforms as T
        right = (T.materialize_block_diag(self._factor(adapter, "2"))
                 if cfg.two_sided else None)
        return (T.materialize_block_diag(self._factor(adapter, "1")), right)

    def param_count(self, d_in, d_out, cfg):
        return 2 * d_in + (2 * d_out if cfg.two_sided else 0)


# ---------------------------------------------------------------------------
# OFT / Naive — blockwise square transforms (in-paper baselines)
# ---------------------------------------------------------------------------

def _square_blocks(cfg, d_in: int) -> tuple[int, int]:
    from repro_torch.core.transforms import resolve_blocks
    n = resolve_blocks(cfg.n_blocks, d_in)
    return n, d_in // n


class _BlockSquareMethod(PEFTMethod):
    """OFT and Naive: a square transform Q per block of the input dim."""

    def _blocks(self, adapter) -> torch.Tensor:
        raise NotImplementedError

    def dense(self, x, W, adapter, cfg):
        from repro_torch.core import transforms as T
        Q = self._blocks(adapter)
        if cfg.mode != "activation":
            return x @ T.block_diag_matmul(Q, W).to(x.dtype)
        # (Q_B W)ᵀx = Wᵀ Q_Bᵀ x: Qᵀ applied blockwise to the activations
        xb = torch.einsum("...ni,nij->...nj", T._blockify(x, Q.shape[0]),
                          Q.to(x.dtype))
        return T._deblockify(xb) @ W.to(x.dtype)

    def merge(self, W, adapter, cfg, *, literal=False):
        from repro_torch.core.transforms import block_diag_matmul
        return block_diag_matmul(self._blocks(adapter), W)

    def materialize(self, adapter, cfg, d_in, d_out):
        from repro_torch.core.transforms import materialize_block_diag
        return (materialize_block_diag(self._blocks(adapter)), None)


@register_method
class OFTMethod(_BlockSquareMethod):
    name = "oft"

    def init(self, generator, d_in, d_out, cfg, stack, device):
        n, db = _square_blocks(cfg, d_in)
        # R = 0 ⇒ S = 0 ⇒ Q = I at init (paper §3.1)
        return {"r": torch.zeros((*stack, n, db, db),
                                 dtype=torch_dtype(cfg.adapter_dtype),
                                 device=device)}

    def _blocks(self, adapter):
        # Cayley Q = (I + S)(I − S)⁻¹ per block, S skew-symmetric from R:
        # Q (I − S) = I + S  ⇔  (I − S)ᵀ Qᵀ = (I + S)ᵀ
        R = adapter["r"]
        S = 0.5 * (R - R.transpose(-1, -2))
        eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
        Qt = torch.linalg.solve((eye - S).transpose(-1, -2),
                                (eye + S).transpose(-1, -2))
        return Qt.transpose(-1, -2)

    def param_count(self, d_in, d_out, cfg):
        # Qiu et al.'s convention (paper App. C): the skew-symmetric
        # storage n·db(db−1)/2
        n, db = _square_blocks(cfg, d_in)
        return n * (db * (db - 1) // 2)


@register_method
class NaiveMethod(_BlockSquareMethod):
    name = "naive"

    def init(self, generator, d_in, d_out, cfg, stack, device):
        n, db = _square_blocks(cfg, d_in)
        # an unconstrained block matrix, the identity at init
        eye = torch.eye(db, dtype=torch_dtype(cfg.adapter_dtype),
                        device=device)
        return {"m": eye.expand(*stack, n, db, db).clone()}

    def _blocks(self, adapter):
        return adapter["m"]

    def identity_leaf(self, leaf_name, arr):
        eye = torch.eye(arr.shape[-1], dtype=arr.dtype, device=arr.device)
        return eye.expand(arr.shape).clone()

    def param_count(self, d_in, d_out, cfg):
        n, db = _square_blocks(cfg, d_in)
        return n * db * db


# ---------------------------------------------------------------------------
# LoRA and full finetuning (in-paper baselines)
# ---------------------------------------------------------------------------

@register_method
class LoRAMethod(PEFTMethod):
    name = "lora"

    def init(self, generator, d_in, d_out, cfg, stack, device):
        dt = torch_dtype(cfg.adapter_dtype)
        r = min(cfg.rank, d_in, d_out)
        a = torch.randn((*stack, d_in, r), generator=generator, dtype=dt,
                        device=device) * (1.0 / math.sqrt(d_in))
        return {"a": a, "b": torch.zeros((*stack, r, d_out), dtype=dt,
                                         device=device)}  # ΔW = 0 at init

    def dense(self, x, W, adapter, cfg):
        a, b = adapter["a"], adapter["b"]
        y = x @ W.to(x.dtype)
        return y + ((x @ a.to(x.dtype)) @ b.to(x.dtype)) * (
            cfg.alpha / a.shape[-1])

    def merge(self, W, adapter, cfg, *, literal=False):
        a, b = adapter["a"], adapter["b"]
        return W + (a @ b).to(W.dtype) * (cfg.alpha / a.shape[-1])

    def param_count(self, d_in, d_out, cfg):
        return min(cfg.rank, d_in, d_out) * (d_in + d_out)


@register_method
class FullFinetune(PEFTMethod):
    """Every float base parameter trains (``peft.trainable_mask``); the
    adapted linear is the plain product, differentiated by autograd, as
    the JAX package leaves it to XLA's AD."""

    name = "full"

    def init(self, generator, d_in, d_out, cfg, stack, device):
        return {}

    def dense(self, x, W, adapter, cfg):
        return x @ W.to(x.dtype)

    def merge(self, W, adapter, cfg, *, literal=False):
        return W

    def param_count(self, d_in, d_out, cfg):
        return d_in * d_out


# ---------------------------------------------------------------------------
# DeLoRA and HyperAdapt — on kernels of their own
# ---------------------------------------------------------------------------

@register_method
class DeLoRAMethod(PEFTMethod):
    """ΔW = (λ/r) Σ_j a_j b_jᵀ / (‖a_j‖‖b_j‖): LoRA's update with its norm
    (the boundary λ, trained) decoupled from its direction.  The
    normalisation is folded into an r-vector s_j = (λ/r)/(‖a_j‖‖b_j‖ + ε)
    computed here with plain autograd, so the hot op is the fused GEMM
    ``y = xW + ((x a)·s) b`` (``delora_gemm``) and the ε-norm chain never
    enters the kernels, as in the JAX package."""

    name = "delora"
    bank_servable = True

    def init(self, generator, d_in, d_out, cfg, stack, device):
        dt = torch_dtype(cfg.adapter_dtype)
        r = min(cfg.rank, d_in, d_out)
        a = torch.randn((*stack, d_in, r), generator=generator, dtype=dt,
                        device=device) * (1.0 / math.sqrt(d_in))
        # b = 0 ⇒ ΔW = 0 at init; λ starts at alpha, one 0-d leaf per
        # linear (stacked to (L,))
        return {"a": a,
                "b": torch.zeros((*stack, r, d_out), dtype=dt, device=device),
                "lam": torch.full(stack, cfg.alpha, dtype=dt, device=device)}

    @staticmethod
    def scale(a, b, lam):
        """s = (λ/r)/(‖a_j‖‖b_j‖ + ε) in float32; (..., r) for stacked
        leaves.  a: (..., d, r); b: (..., r, f); lam: (...).

        At b = 0 (the init) ‖b_j‖ has no derivative.  ``torch.linalg.norm``
        gives it the zero subgradient, so the gradient through s is finite
        and b moves through its direct cotangent; the JAX package's
        ``jnp.linalg.norm`` gives NaN there (ROADMAP.md, Queue 3).  Once
        b ≠ 0 the two agree."""
        r = a.shape[-1]
        na = torch.linalg.norm(a.float(), dim=-2)
        nb = torch.linalg.norm(b.float(), dim=-1)
        return (lam.float()[..., None] / r) / (na * nb + _EPS)

    def dense(self, x, W, adapter, cfg):
        if cfg.mode != "activation":
            # s rounded to W's dtype inside the merge, as the JAX package
            # rounds it in these modes
            return x @ self.merge(W, adapter, cfg).to(x.dtype)
        a, b = adapter["a"], adapter["b"]
        # s rounded to the activation dtype before the GEMM, as the JAX
        # package rounds it
        s = self.scale(a, b, adapter["lam"]).to(x.dtype)
        if _needs_grad(x, W, a, b, s):
            return execute.DeloraGemm.apply(x, W, a, b, s, cfg.backend)
        return execute.dispatch("delora_gemm", cfg.backend, x, W, a, b, s)

    def bank_dense(self, x, W, adapter, cfg):
        # s for every tenant of the bank, (A, r), each forward, as the JAX
        # package computes it (src/repro/core/methods.py:527-531)
        a, b = adapter["a"], adapter["b"]
        _serving_only(x, W, a, b, adapter["lam"])
        s = self.scale(a, b, adapter["lam"]).to(x.dtype)
        return execute.dispatch("delora_gemm_batched", cfg.backend, x, W, a,
                                b, s, adapter["ids"])

    def merge(self, W, adapter, cfg, *, literal=False):
        a, b = adapter["a"], adapter["b"]
        s = self.scale(a, b, adapter["lam"]).to(W.dtype)
        if _needs_grad(W, a, b, s):
            return execute.DeloraMerge.apply(W, a, b, s, cfg.backend)
        return execute.dispatch("delora_merge", cfg.backend, W, a, b, s)

    def param_count(self, d_in, d_out, cfg):
        return min(cfg.rank, d_in, d_out) * (d_in + d_out) + 1   # +1: λ


@register_method
class HyperAdaptMethod(PEFTMethod):
    """W' = diag(r) W diag(c): per-input- and per-output-feature scales,
    d_in + d_out parameters a linear, applied inside ``hyperadapt_gemm``.
    Its identity is r = c = ones, not zeros (:meth:`identity_leaf`)."""

    name = "hyperadapt"
    bank_servable = True

    def init(self, generator, d_in, d_out, cfg, stack, device):
        dt = torch_dtype(cfg.adapter_dtype)
        return {"r": torch.ones((*stack, d_in), dtype=dt, device=device),
                "c": torch.ones((*stack, d_out), dtype=dt, device=device)}

    def identity_leaf(self, leaf_name, arr):
        return torch.ones_like(arr)

    def dense(self, x, W, adapter, cfg):
        if cfg.mode != "activation":
            return x @ self.merge(W, adapter, cfg).to(x.dtype)
        r, c = adapter["r"], adapter["c"]
        if _needs_grad(x, W, r, c):
            return execute.HyperAdaptGemm.apply(x, W, r, c, cfg.backend)
        return execute.dispatch("hyperadapt_gemm", cfg.backend, x, W, r, c)

    def bank_dense(self, x, W, adapter, cfg):
        r, c = adapter["r"], adapter["c"]
        _serving_only(x, W, r, c)
        return execute.dispatch("hyperadapt_gemm_batched", cfg.backend, x, W,
                                r, c, adapter["ids"])

    def merge(self, W, adapter, cfg, *, literal=False):
        r, c = adapter["r"], adapter["c"]
        if _needs_grad(W, r, c):
            return execute.HyperAdaptMerge.apply(W, r, c, cfg.backend)
        return execute.dispatch("hyperadapt_merge", cfg.backend, W, r, c)

    def materialize(self, adapter, cfg, d_in, d_out):
        return (torch.diag(adapter["r"]), torch.diag(adapter["c"]))

    def param_count(self, d_in, d_out, cfg):
        return d_in + d_out
