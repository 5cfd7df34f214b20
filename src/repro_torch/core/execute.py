"""Execution-backend dispatch for the ETHER hot ops.

``core.methods`` routes every ETHER compute through this registry, which
maps ``(op, backend)`` to an implementation:

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
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.kernels import ops, ref

BACKENDS = ("torch", "cuda", "auto")

_REGISTRY: dict[tuple[str, str], Callable[..., Any]] = {
    ("householder_gemm", "torch"): ref.ref_householder_gemm,
    ("householder_gemm", "cuda"): ops.householder_gemm,
    ("ether_merge", "torch"): ref.ref_ether_merge,
    ("ether_merge", "cuda"): ops.ether_merge,
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


def dispatch(op: str, backend: str, *args):
    """Run ``op`` on the resolved backend and count the call."""
    be = selected_backend(op, backend, args[0])
    impl = _REGISTRY.get((op, be))
    if impl is None:
        raise KeyError(f"no {be!r} implementation registered for {op!r}")
    key = f"{op}.{be}"
    _COUNTERS[key] = _COUNTERS.get(key, 0) + 1
    return impl(*args)


def counters() -> dict[str, int]:
    """Calls per ``op.backend`` since the last reset."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()
