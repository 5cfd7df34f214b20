"""PEFT method registry of the port.

Every finetuning transform is a :class:`PEFTMethod`: adapter factory
(``init``), adapted forward (``dense``), absorption (``merge``) and
parameter accounting.  The port has ETHER and ETHER+ so far; :func:`get`
raises :class:`repro_torch.NotPortedError` for every other name, known to
the JAX package or not.  The hot ops dispatch through
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


@register_method
class EtherPlusMethod(PEFTMethod):
    """ETHER+: H⁺ = I − ûûᵀ + v̂v̂ᵀ per block of the input (u1, v1) and,
    two-sided (``cfg.two_sided``, the paper's default), H̃⁺ on the output
    blocks (u2, v2)."""

    name = "etherplus"

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
        u1, v1 = adapter["u1"], adapter["v1"]
        u2, v2 = self._pair(adapter, cfg)
        # serving (no_grad, or nothing to differentiate) calls the forward
        # itself and pays nothing for autograd
        leaves = [t for t in (x, W, u1, v1, u2, v2) if t is not None]
        if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
            return execute.EtherPlusGemm.apply(x, W, u1, v1, u2, v2,
                                               cfg.backend)
        return execute.dispatch("etherplus_gemm", cfg.backend, x, W, u1, v1,
                                u2, v2)

    def merge(self, W, adapter, cfg):
        u2, v2 = self._pair(adapter, cfg)
        return execute.dispatch("etherplus_merge", cfg.backend, W,
                                adapter["u1"], adapter["v1"], u2, v2)

    def param_count(self, d_in, d_out, cfg):
        return 2 * d_in + (2 * d_out if cfg.two_sided else 0)
