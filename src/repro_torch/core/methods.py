"""PEFT method registry of the port.

Every finetuning transform is a :class:`PEFTMethod`: adapter factory
(``init``), adapted forward (``dense``), absorption (``merge``) and
parameter accounting.  The port has ETHER so far; :func:`get` raises
:class:`repro_torch.NotPortedError` for every other name, known to the
JAX package or not.  The hot ops dispatch through
:mod:`repro_torch.core.execute`.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import NotPortedError
from repro_torch.common.dtypes import torch_dtype
from repro_torch.core import execute

Params = dict[str, Any]

_METHOD_REGISTRY: dict[str, "PEFTMethod"] = {}


def register_method(cls):
    """Class decorator: add one instance of ``cls`` to the registry."""
    inst = cls()
    _METHOD_REGISTRY[inst.name] = inst
    return cls


def available() -> tuple[str, ...]:
    """Registered method names, in registration order."""
    return tuple(_METHOD_REGISTRY)


def get(name: str) -> "PEFTMethod":
    try:
        return _METHOD_REGISTRY[name]
    except KeyError:
        raise NotPortedError(f"PEFT method {name!r} (ported: "
                             f"{', '.join(available())})") from None


class PEFTMethod:
    """One PEFT method; ``cfg`` is a ``transforms.PEFTConfig``.
    ``dense`` takes x with any leading dims and does not add the bias."""

    name: str = ""

    def init(self, generator: torch.Generator, d_in: int, d_out: int, cfg,
             stack: tuple[int, ...], device) -> Params:
        raise NotImplementedError

    def dense(self, x, W, adapter: Params, cfg) -> torch.Tensor:
        raise NotImplementedError

    def merge(self, W, adapter: Params, cfg) -> torch.Tensor:
        raise NotImplementedError

    def param_count(self, d_in: int, d_out: int, cfg) -> int:
        raise NotImplementedError


@register_method
class EtherMethod(PEFTMethod):
    name = "ether"

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
        # serving (no_grad, or nothing to differentiate) calls the forward
        # itself and pays nothing for autograd
        if torch.is_grad_enabled() and (x.requires_grad or W.requires_grad
                                        or u.requires_grad):
            return execute.HouseholderGemm.apply(x, W, u, cfg.backend)
        return execute.dispatch("householder_gemm", cfg.backend, x, W, u)

    def merge(self, W, adapter, cfg):
        return execute.dispatch("ether_merge", cfg.backend, W, adapter["u"])

    def param_count(self, d_in, d_out, cfg):
        return d_in                                 # O(d), n-independent
