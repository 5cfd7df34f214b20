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
    ``cuda`` for CUDA tensors, ``torch`` for the rest.  There is no
    shape-based choice: the kernels take every shape.

``counters()`` counts the calls each ``op.backend`` pair ran, so a run
can show which implementation it went through.

Training differentiates ``householder_gemm`` through
:class:`HouseholderGemm`, ``etherplus_gemm`` through
:class:`EtherPlusGemm`, ``delora_gemm`` through :class:`DeloraGemm` and
``hyperadapt_gemm`` through :class:`HyperAdaptGemm`, and, in weight mode,
the merges through :class:`EtherMerge`, :class:`EtherPlusMerge`,
:class:`DeloraMerge` and :class:`HyperAdaptMerge`:
``torch.autograd.Function``s whose backward dispatches ``<op>_bwd`` on
the backend its forward resolved (counted as ``<op>_bwd.<backend>``), as
the JAX package's ``_registry_vjp`` dispatches ``<op>_bwd``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.kernels import ops, ref

BACKENDS = ("torch", "cuda", "auto")

_REGISTRY: dict[tuple[str, str], Callable[..., Any]] = {
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
    # multi-tenant bank serving (forward only, as in the JAX package's
    # serving path)
    ("householder_gemm_batched", "torch"): ref.ref_householder_gemm_batched,
    ("householder_gemm_batched", "cuda"): ops.householder_gemm_batched,
    ("etherplus_reflect_batched", "torch"):
        ref.ref_etherplus_reflect_batched,
    ("etherplus_reflect_batched", "cuda"): ops.etherplus_reflect_batched,
    ("delora_gemm_batched", "torch"): ref.ref_delora_gemm_batched,
    ("delora_gemm_batched", "cuda"): ops.delora_gemm_batched,
    ("hyperadapt_gemm_batched", "torch"): ref.ref_hyperadapt_gemm_batched,
    ("hyperadapt_gemm_batched", "cuda"): ops.hyperadapt_gemm_batched,
}
_COUNTERS: dict[str, int] = {}


class BackendError(RuntimeError):
    """The requested backend cannot run on these operands."""


def selected_backend(op: str, backend: str, first) -> str:
    """Resolve ``backend`` for an op whose first operand is ``first``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    on_cuda = first.device.type == "cuda"
    if backend == "auto":
        return "cuda" if on_cuda else "torch"
    if backend == "cuda" and not on_cuda:
        raise BackendError(
            f"backend 'cuda' runs {op!r} only on CUDA tensors, got "
            f"{first.device}; use backend 'torch' or 'auto' off the card")
    return backend


def dispatch(op: str, backend: str, *args, **kwargs):
    """Run ``op`` on the resolved backend and count the call."""
    be = selected_backend(op, backend, args[0])
    impl = _REGISTRY.get((op, be))
    if impl is None:
        raise KeyError(f"no {be!r} implementation registered for {op!r}")
    key = f"{op}.{be}"
    _COUNTERS[key] = _COUNTERS.get(key, 0) + 1
    return impl(*args, **kwargs)


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


def counters() -> dict[str, int]:
    """Calls per ``op.backend`` since the last reset."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()
