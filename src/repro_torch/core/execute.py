"""Execution-backend dispatch for the PEFT methods' hot ops.

``core.methods`` routes every ETHER, ETHER+, DeLoRA and HyperAdapt
compute, single-tenant and bank (``*_batched``), through this registry,
which maps ``(op, backend)`` to an implementation:

``torch``
    The plain PyTorch version of the op (``kernels/ref.py``): float32
    inside, any device.

``cuda``
    The hand-written CUDA kernel through its wrapper (``kernels/ops.py``).
    On tensors that are not on a CUDA device it raises
    :class:`BackendError`; it never computes the plain version instead.

``auto``
    ``cuda`` for CUDA tensors, ``torch`` for the rest; on CUDA tensors an
    op with a ``supports_rule`` takes ``cuda`` only where its rule accepts
    the operands, as the JAX registry's ``auto`` consults its rules
    (src/repro/core/execute.py:77-106).  The one rule is
    ``flash_attention``'s (its kernel takes head widths 32, 64 and 128);
    every other kernel takes every shape.  An explicit ``cuda`` asks for
    the kernel whatever the rule says, and its wrapper raises
    :class:`repro_torch.kernels.ops.KernelInputError` on what it refuses.

``counters()`` counts the calls each ``op.backend`` pair ran, so a run
can show which implementation it went through (``counters("bwd")`` the
``*_bwd`` ops alone); ``available(op)`` lists an op's backends.

The registry also holds the JAX registry's standalone reflections
``ether_reflect`` (H_B x over any leading dims) and
``ether_reflect_batched`` (each sequence of a (B, S, d) batch by its
tenant of a bank), which no model calls.  Mamba-2's chunked scan
``ssd_chunked`` (``models/ssm.py``) dispatches here too: ``cuda`` runs its
chunks on the SSD kernel (``ops.ssd_chunk``), ``torch`` on their plain
version (``ref.ref_ssd_chunk``).  Every dense decoder's attention
(``models/attention.py``) dispatches ``flash_attention``: ``cuda`` runs
the flash kernel (``ops.flash_attention``), ``torch`` its plain version
chunked over queries (``ref.ref_flash_attention``, the JAX package's
einsum ``attention_core``), which is also the route of training.

``dispatch`` is differentiable on every backend, as the JAX package's
pallas ops are through ``_registry_vjp``: a forward op dispatched while
grad is enabled and an operand requires grad runs under its autograd
Function (``FUNCTIONS``), whose backward dispatches ``<op>_bwd`` on the
backend its forward resolved (counted as ``<op>_bwd.<backend>``).
Without grad it calls the implementation directly, so serving pays
nothing for autograd.  ``ssd_chunked`` and ``flash_attention`` have no
Function (the JAX package has no backward for either kernel): under grad
their ``torch`` route is plain autograd and their ``cuda`` route raises
:class:`repro_torch.NotPortedError` rather than return an output without
a gradient.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import NotPortedError
from repro_torch.kernels import ops, ref

BACKENDS = ("torch", "cuda", "auto")


def _ssd_chunked(intra):
    """``models.ssm.ssd_chunked`` with its chunks on ``intra``."""
    def run(*args, **kwargs):
        # imported at the call: models.ssm imports this module
        from repro_torch.models.ssm import ssd_chunked
        return ssd_chunked(*args, intra=intra, **kwargs)
    return run


_REGISTRY: dict[tuple[str, str], Callable[..., Any]] = {
    # the standalone reflections, single-tenant and through a bank
    ("ether_reflect", "torch"): ref.ref_ether_reflect,
    ("ether_reflect", "cuda"): ops.ether_reflect,
    ("ether_reflect_bwd", "torch"): ref.ref_ether_reflect_bwd,
    ("ether_reflect_bwd", "cuda"): ops.ether_reflect_bwd,
    ("ether_reflect_batched", "torch"): ref.ref_ether_reflect_batched,
    ("ether_reflect_batched", "cuda"): ops.ether_reflect_batched,
    ("ether_reflect_batched_bwd", "torch"): ref.ref_ether_reflect_batched_bwd,
    ("ether_reflect_batched_bwd", "cuda"): ops.ether_reflect_batched_bwd,
    ("householder_gemm", "torch"): ref.ref_householder_gemm,
    ("householder_gemm", "cuda"): ops.householder_gemm,
    ("householder_gemm_bwd", "torch"): ref.ref_householder_gemm_bwd,
    ("householder_gemm_bwd", "cuda"): ops.householder_gemm_bwd,
    ("ether_merge", "torch"): ref.ref_ether_merge,
    ("ether_merge", "cuda"): ops.ether_merge,
    ("ether_merge_bwd", "torch"): ref.ref_ether_merge_bwd,
    ("ether_merge_bwd", "cuda"): ops.merge_left_bwd,
    ("etherplus_gemm", "torch"): ref.ref_etherplus_gemm,
    ("etherplus_gemm", "cuda"): ops.etherplus_gemm,
    ("etherplus_gemm_bwd", "torch"): ref.ref_etherplus_gemm_bwd,
    ("etherplus_gemm_bwd", "cuda"): ops.etherplus_gemm_bwd,
    ("etherplus_merge", "torch"): ref.ref_etherplus_merge,
    ("etherplus_merge", "cuda"): ops.etherplus_merge,
    ("etherplus_merge_bwd", "torch"): ref.ref_etherplus_merge_bwd,
    ("etherplus_merge_bwd", "cuda"): ops.etherplus_merge_bwd,
    ("delora_gemm", "torch"): ref.ref_delora_gemm,
    ("delora_gemm", "cuda"): ops.delora_gemm,
    ("delora_gemm_bwd", "torch"): ref.ref_delora_gemm_bwd,
    ("delora_gemm_bwd", "cuda"): ops.delora_gemm_bwd,
    ("delora_merge", "torch"): ref.ref_delora_merge,
    ("delora_merge", "cuda"): ops.delora_merge,
    # pure glue on either device: no kernel to win (the JAX package's
    # ops.delora_merge_bwd)
    ("delora_merge_bwd", "torch"): ref.ref_delora_merge_bwd,
    ("delora_merge_bwd", "cuda"): ref.ref_delora_merge_bwd,
    ("hyperadapt_gemm", "torch"): ref.ref_hyperadapt_gemm,
    ("hyperadapt_gemm", "cuda"): ops.hyperadapt_gemm,
    ("hyperadapt_gemm_bwd", "torch"): ref.ref_hyperadapt_gemm_bwd,
    ("hyperadapt_gemm_bwd", "cuda"): ops.hyperadapt_gemm_bwd,
    ("hyperadapt_merge", "torch"): ref.ref_hyperadapt_merge,
    ("hyperadapt_merge", "cuda"): ops.hyperadapt_merge,
    ("hyperadapt_merge_bwd", "torch"): ref.ref_hyperadapt_merge_bwd,
    ("hyperadapt_merge_bwd", "cuda"): ops.hyperadapt_merge_bwd,
    # multi-tenant banks: serving, and training through a bank
    ("householder_gemm_batched", "torch"): ref.ref_householder_gemm_batched,
    ("householder_gemm_batched", "cuda"): ops.householder_gemm_batched,
    ("etherplus_reflect_batched", "torch"):
        ref.ref_etherplus_reflect_batched,
    ("etherplus_reflect_batched", "cuda"): ops.etherplus_reflect_batched,
    ("delora_gemm_batched", "torch"): ref.ref_delora_gemm_batched,
    ("delora_gemm_batched", "cuda"): ops.delora_gemm_batched,
    ("hyperadapt_gemm_batched", "torch"): ref.ref_hyperadapt_gemm_batched,
    ("hyperadapt_gemm_batched", "cuda"): ops.hyperadapt_gemm_batched,
    ("householder_gemm_batched_bwd", "torch"):
        ref.ref_householder_gemm_batched_grads,
    ("householder_gemm_batched_bwd", "cuda"): ops.householder_gemm_batched_bwd,
    ("etherplus_reflect_batched_bwd", "torch"):
        ref.ref_etherplus_reflect_batched_grads,
    ("etherplus_reflect_batched_bwd", "cuda"):
        ops.etherplus_reflect_batched_bwd,
    ("delora_gemm_batched_bwd", "torch"): ref.ref_delora_gemm_batched_bwd,
    ("delora_gemm_batched_bwd", "cuda"): ops.delora_gemm_batched_bwd,
    ("hyperadapt_gemm_batched_bwd", "torch"):
        ref.ref_hyperadapt_gemm_batched_bwd,
    ("hyperadapt_gemm_batched_bwd", "cuda"): ops.hyperadapt_gemm_batched_bwd,
    # Mamba-2's chunked scan (serving; no backward yet)
    ("ssd_chunked", "torch"): _ssd_chunked(ref.ref_ssd_chunk),
    ("ssd_chunked", "cuda"): _ssd_chunked(ops.ssd_chunk),
    # every dense decoder's attention (no backward kernel)
    ("flash_attention", "torch"): ref.ref_flash_attention,
    ("flash_attention", "cuda"): ops.flash_attention,
}
_COUNTERS: dict[str, int] = {}
# op -> the predicate ``auto`` consults before it picks the op's kernel
_SUPPORTS: dict[str, Callable[..., bool]] = {}


class BackendError(RuntimeError):
    """The requested backend cannot run on these operands."""


def supports_rule(op: str):
    """Decorator: register the predicate on an op's operands that ``auto``
    consults before it picks the op's kernel."""
    def deco(fn):
        _SUPPORTS[op] = fn
        return fn
    return deco


def supports(op: str, *args, **kwargs) -> bool:
    """True where ``op``'s kernel takes these operands: its rule's answer,
    and True for an op without a rule (its kernel takes every shape)."""
    rule = _SUPPORTS.get(op)
    return rule is None or bool(rule(*args, **kwargs))


@supports_rule("flash_attention")
def _flash_attention_supported(q, k, v, *, window=None, q_offset=0,
                               **_) -> bool:
    """Where the kernel's own check (``ops._flash_refusal``) takes the
    operands: head widths 32, 64 and 128, among its other conditions."""
    return ops._flash_refusal(q, k, v, window, q_offset) is None


def selected_backend(op: str, backend: str, first, *rest, **kwargs) -> str:
    """Resolve ``backend`` for an op whose operands are ``first``,
    ``*rest`` and ``**kwargs`` (``auto`` reads them only for an op with a
    rule)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    on_cuda = first.device.type == "cuda"
    if backend == "auto":
        return ("cuda" if on_cuda and supports(op, first, *rest, **kwargs)
                else "torch")
    if backend == "cuda" and not on_cuda:
        raise BackendError(
            f"backend 'cuda' runs {op!r} only on CUDA tensors, got "
            f"{first.device}; use backend 'torch' or 'auto' off the card")
    return backend


def available(op: str) -> tuple[str, ...]:
    """Backends registered for ``op`` (``auto`` resolves to one of them)."""
    return tuple(b for (o, b) in _REGISTRY if o == op)


def is_bwd_op(op: str) -> bool:
    """True for the registered backward ops (the ``*_bwd`` tier)."""
    return op.endswith("_bwd")


def _needs_grad(args, kwargs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad
        for a in (*args, *kwargs.values()))


def dispatch(op: str, backend: str, *args, **kwargs):
    """Run ``op`` on the resolved backend and count the call; under
    autograd a forward op runs through its Function (``FUNCTIONS``),
    which counts the call once."""
    be = selected_backend(op, backend, *args, **kwargs)
    if _needs_grad(args, kwargs) and not is_bwd_op(op):
        fn = FUNCTIONS.get(op)
        if fn is not None:
            # the Function's forward runs without grad and dispatches
            # again; optional operands it was not given are None
            arity = fn.forward.__code__.co_argcount - 2   # ctx, backend
            return fn.apply(*args, *(None,) * (arity - len(args)), be,
                            **kwargs)
        if be == "cuda":
            raise NotPortedError(f"the gradient of {op!r} on the 'cuda' "
                                 f"backend")
    impl = _REGISTRY.get((op, be))
    if impl is None:
        raise KeyError(f"no {be!r} implementation registered for {op!r}")
    key = f"{op}.{be}"
    _COUNTERS[key] = _COUNTERS.get(key, 0) + 1
    return impl(*args, **kwargs)


class EtherReflect(torch.autograd.Function):
    """H_B x with the registry's backward, as ``EtherReflect.apply(x, u,
    backend)``; x takes any leading dims.  Saves the operands themselves
    (the backward recomputes û), as the JAX package's ``_registry_vjp``
    does."""

    @staticmethod
    def forward(ctx, x, u, backend):
        be = selected_backend("ether_reflect", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, u)
        return dispatch("ether_reflect", be, x, u)

    @staticmethod
    def backward(ctx, g):
        x, u = ctx.saved_tensors
        dx, du = dispatch("ether_reflect_bwd", ctx.backend, x, u,
                          g.contiguous())
        return dx, du, None


class EtherReflectBatched(torch.autograd.Function):
    """R_{ids[b]} x[b] through an adapter bank with the registry's
    backward, as ``EtherReflectBatched.apply(x, u_bank, ids, backend)``.
    ids take no gradient; du_bank sums each sequence's gradient into its
    tenant's row (an exact zero for a tenant no id names)."""

    @staticmethod
    def forward(ctx, x, u_bank, ids, backend):
        be = selected_backend("ether_reflect_batched", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, u_bank, ids)
        return dispatch("ether_reflect_batched", be, x, u_bank, ids)

    @staticmethod
    def backward(ctx, g):
        x, u_bank, ids = ctx.saved_tensors
        dx, du = dispatch("ether_reflect_batched_bwd", ctx.backend, x,
                          u_bank, ids, g.contiguous())
        return dx, du, None, None


class HouseholderGemm(torch.autograd.Function):
    """y = reflect(x) @ w with the registry's backward, as
    ``HouseholderGemm.apply(x, w, u, backend)``.  Saves the
    operands themselves (the backward recomputes û, O(d)), as the JAX
    package's ``_registry_vjp`` does; dW is computed only when w needs
    a gradient, the counterpart of XLA dead-coding the dW pass."""

    @staticmethod
    def forward(ctx, x, w, u, backend):
        be = selected_backend("householder_gemm", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, w, u)
        return dispatch("householder_gemm", be, x, w, u)

    @staticmethod
    def backward(ctx, g):
        x, w, u = ctx.saved_tensors
        dx, dw, du = dispatch("householder_gemm_bwd", ctx.backend, x, w, u,
                              g.contiguous(),
                              need_dw=ctx.needs_input_grad[1])
        return dx, dw, du, None


class EtherPlusGemm(torch.autograd.Function):
    """y = (H⁺x) @ w [·H̃⁺] with the registry's backward, as
    ``EtherPlusGemm.apply(x, w, u1, v1, u2, v2, backend)`` (u2, v2 None
    one-sided).  Saves the operands themselves: the two-sided backward
    recomputes the pre-epilogue product, as the JAX package's
    ``_registry_vjp`` does; dW only when w needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, u1, v1, u2, v2, backend):
        be = selected_backend("etherplus_gemm", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, w, u1, v1, u2, v2)
        return dispatch("etherplus_gemm", be, x, w, u1, v1, u2, v2)

    @staticmethod
    def backward(ctx, g):
        x, w, u1, v1, u2, v2 = ctx.saved_tensors
        grads = dispatch("etherplus_gemm_bwd", ctx.backend, x, w, u1, v1, u2,
                         v2, g.contiguous(), need_dw=ctx.needs_input_grad[1])
        return (*grads, None)


class DeloraGemm(torch.autograd.Function):
    """y = x @ w + ((x @ a)·s) @ b with the registry's backward, as
    ``DeloraGemm.apply(x, w, a, b, s, backend)``.  s is a primal here:
    its own gradient (the ε-norm chain to a, b and λ) flows through plain
    autograd outside the Function, as the JAX package leaves it to XLA's
    AD.  Saves the operands; dW only when w needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, a, b, s, backend):
        be = selected_backend("delora_gemm", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, w, a, b, s)
        return dispatch("delora_gemm", be, x, w, a, b, s)

    @staticmethod
    def backward(ctx, g):
        grads = dispatch("delora_gemm_bwd", ctx.backend, *ctx.saved_tensors,
                         g.contiguous(), need_dw=ctx.needs_input_grad[1])
        return (*grads, None)


class HyperAdaptGemm(torch.autograd.Function):
    """y = ((x·r) @ w)·c with the registry's backward, as
    ``HyperAdaptGemm.apply(x, w, r, c, backend)``.  Saves the operands:
    the backward recomputes y0 = (x·r) @ w, as the JAX package's does;
    dW only when w needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, r, c, backend):
        be = selected_backend("hyperadapt_gemm", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, w, r, c)
        return dispatch("hyperadapt_gemm", be, x, w, r, c)

    @staticmethod
    def backward(ctx, g):
        grads = dispatch("hyperadapt_gemm_bwd", ctx.backend,
                         *ctx.saved_tensors, g.contiguous(),
                         need_dw=ctx.needs_input_grad[1])
        return (*grads, None)


class EtherMerge(torch.autograd.Function):
    """W' = H_B·w with the registry's backward, as
    ``EtherMerge.apply(w, u, backend)``.  Saves the operands themselves,
    as the JAX package's ``_registry_vjp`` does; dW only when w needs a
    gradient (never under PEFT, which freezes w)."""

    @staticmethod
    def forward(ctx, w, u, backend):
        be = selected_backend("ether_merge", backend, w)
        ctx.backend = be
        ctx.save_for_backward(w, u)
        return dispatch("ether_merge", be, w, u)

    @staticmethod
    def backward(ctx, g):
        w, u = ctx.saved_tensors
        dw, du = dispatch("ether_merge_bwd", ctx.backend, w, u,
                          g.contiguous(), need_dw=ctx.needs_input_grad[0])
        return dw, du, None


class EtherPlusMerge(torch.autograd.Function):
    """W' = H⁺·w [·H̃⁺] with the registry's backward, as
    ``EtherPlusMerge.apply(w, u1, v1, u2, v2, backend)`` (u2, v2 None
    one-sided).  Saves the operands: the two-sided backward recomputes
    H⁺·w, as the JAX package's does; dW only when w needs a gradient."""

    @staticmethod
    def forward(ctx, w, u1, v1, u2, v2, backend):
        be = selected_backend("etherplus_merge", backend, w)
        ctx.backend = be
        ctx.save_for_backward(w, u1, v1, u2, v2)
        return dispatch("etherplus_merge", be, w, u1, v1, u2, v2)

    @staticmethod
    def backward(ctx, g):
        grads = dispatch("etherplus_merge_bwd", ctx.backend,
                         *ctx.saved_tensors, g.contiguous(),
                         need_dw=ctx.needs_input_grad[0])
        return (*grads, None)


class DeloraMerge(torch.autograd.Function):
    """W' = w + (a·s)·b with the registry's backward, as
    ``DeloraMerge.apply(w, a, b, s, backend)``.  s is a primal here, its
    ε-norm chain left to plain autograd outside, as in
    :class:`DeloraGemm`; the backward is thin glue on either backend (the
    JAX package's ``ops.delora_merge_bwd``); dW only when w needs a
    gradient."""

    @staticmethod
    def forward(ctx, w, a, b, s, backend):
        be = selected_backend("delora_merge", backend, w)
        ctx.backend = be
        ctx.save_for_backward(w, a, b, s)
        return dispatch("delora_merge", be, w, a, b, s)

    @staticmethod
    def backward(ctx, g):
        grads = dispatch("delora_merge_bwd", ctx.backend, *ctx.saved_tensors,
                         g.contiguous(), need_dw=ctx.needs_input_grad[0])
        return (*grads, None)


class HyperAdaptMerge(torch.autograd.Function):
    """W' = diag(r)·w·diag(c) with the registry's backward, as
    ``HyperAdaptMerge.apply(w, r, c, backend)``; dW (the merge kernel on
    the cotangent) only when w needs a gradient."""

    @staticmethod
    def forward(ctx, w, r, c, backend):
        be = selected_backend("hyperadapt_merge", backend, w)
        ctx.backend = be
        ctx.save_for_backward(w, r, c)
        return dispatch("hyperadapt_merge", be, w, r, c)

    @staticmethod
    def backward(ctx, g):
        grads = dispatch("hyperadapt_merge_bwd", ctx.backend,
                         *ctx.saved_tensors, g.contiguous(),
                         need_dw=ctx.needs_input_grad[0])
        return (*grads, None)


class HouseholderGemmBatched(torch.autograd.Function):
    """y[b] = R_{ids[b]}(x[b]) @ w through an adapter bank with the
    registry's backward, as ``HouseholderGemmBatched.apply(x, w, u_bank,
    ids, backend)``.  ids take no gradient; du_bank sums each sequence's
    gradient into its tenant's row; dW only when w needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, u_bank, ids, backend):
        be = selected_backend("householder_gemm_batched", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, w, u_bank, ids)
        return dispatch("householder_gemm_batched", be, x, w, u_bank, ids)

    @staticmethod
    def backward(ctx, g):
        x, w, u_bank, ids = ctx.saved_tensors
        dx, dw, du = dispatch("householder_gemm_batched_bwd", ctx.backend, x,
                              w, u_bank, ids, g.contiguous(),
                              need_dw=ctx.needs_input_grad[1])
        return dx, dw, du, None, None


class EtherPlusReflectBatched(torch.autograd.Function):
    """H⁺_{ids[b]} x[b] through an ETHER+ bank with the registry's
    backward, as ``EtherPlusReflectBatched.apply(x, u_bank, v_bank, ids,
    backend)``; ETHER+'s bank forward runs it on each side of the shared
    product, which stays under plain autograd."""

    @staticmethod
    def forward(ctx, x, u_bank, v_bank, ids, backend):
        be = selected_backend("etherplus_reflect_batched", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, u_bank, v_bank, ids)
        return dispatch("etherplus_reflect_batched", be, x, u_bank, v_bank,
                        ids)

    @staticmethod
    def backward(ctx, g):
        grads = dispatch("etherplus_reflect_batched_bwd", ctx.backend,
                         *ctx.saved_tensors, g.contiguous())
        return (*grads, None, None)


class DeloraGemmBatched(torch.autograd.Function):
    """The bank DeLoRA GEMM with the registry's backward, as
    ``DeloraGemmBatched.apply(x, w, a_bank, b_bank, s_bank, ids,
    backend)``.  s_bank is a primal (every tenant's scale, its ε-norm
    chain left to plain autograd outside); dW only when w needs a
    gradient."""

    @staticmethod
    def forward(ctx, x, w, a_bank, b_bank, s_bank, ids, backend):
        be = selected_backend("delora_gemm_batched", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, w, a_bank, b_bank, s_bank, ids)
        return dispatch("delora_gemm_batched", be, x, w, a_bank, b_bank,
                        s_bank, ids)

    @staticmethod
    def backward(ctx, g):
        grads = dispatch("delora_gemm_batched_bwd", ctx.backend,
                         *ctx.saved_tensors, g.contiguous(),
                         need_dw=ctx.needs_input_grad[1])
        return (*grads, None, None)


class HyperAdaptGemmBatched(torch.autograd.Function):
    """The bank HyperAdapt GEMM with the registry's backward, as
    ``HyperAdaptGemmBatched.apply(x, w, r_bank, c_bank, ids, backend)``;
    dW only when w needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, r_bank, c_bank, ids, backend):
        be = selected_backend("hyperadapt_gemm_batched", backend, x)
        ctx.backend = be
        ctx.save_for_backward(x, w, r_bank, c_bank, ids)
        return dispatch("hyperadapt_gemm_batched", be, x, w, r_bank, c_bank,
                        ids)

    @staticmethod
    def backward(ctx, g):
        grads = dispatch("hyperadapt_gemm_batched_bwd", ctx.backend,
                         *ctx.saved_tensors, g.contiguous(),
                         need_dw=ctx.needs_input_grad[1])
        return (*grads, None, None)


# op -> the autograd Function that differentiates it: ``dispatch`` under
# grad and the methods (through ``dispatch``) take the same one
FUNCTIONS: dict[str, type] = {
    "ether_reflect": EtherReflect,
    "ether_reflect_batched": EtherReflectBatched,
    "householder_gemm": HouseholderGemm,
    "ether_merge": EtherMerge,
    "etherplus_gemm": EtherPlusGemm,
    "etherplus_merge": EtherPlusMerge,
    "delora_gemm": DeloraGemm,
    "delora_merge": DeloraMerge,
    "hyperadapt_gemm": HyperAdaptGemm,
    "hyperadapt_merge": HyperAdaptMerge,
    "householder_gemm_batched": HouseholderGemmBatched,
    "etherplus_reflect_batched": EtherPlusReflectBatched,
    "delora_gemm_batched": DeloraGemmBatched,
    "hyperadapt_gemm_batched": HyperAdaptGemmBatched,
}


def counters(phase: str | None = None) -> dict[str, int]:
    """Calls per ``op.backend`` since the last reset: ``phase="fwd"`` the
    forward ops alone, ``"bwd"`` the ``*_bwd`` ops alone (a backward that
    ran the plain version shows as ``<op>_bwd.torch``)."""
    if phase is None:
        return dict(_COUNTERS)
    if phase not in ("fwd", "bwd"):
        raise ValueError(f"phase must be 'fwd', 'bwd' or None, got "
                         f"{phase!r}")
    want = phase == "bwd"
    return {k: v for k, v in _COUNTERS.items()
            if is_bwd_op(k.split(".", 1)[0]) == want}


def reset_counters() -> None:
    _COUNTERS.clear()
