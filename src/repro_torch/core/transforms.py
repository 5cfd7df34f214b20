"""The ETHER transform (ICML 2024): configuration and entry points.

Conventions, as in the JAX package:

* Weights are stored ``W: (d_in, f_out)`` and dense layers compute
  ``y = x @ W + b``.
* ETHER acts on the input dimension from the left, ``W' = H_B · W``,
  which in row form is ``y = (x @ H_B) @ W`` because H_B is symmetric.
* ``H_B`` is block-diagonal with ``n`` blocks of size ``db = d/n``, kept
  factored as the raw hyperplanes ``u: (n, db)``; the (d × d) transform
  is never built.

Activation mode (the port's only mode so far) reflects the activations
inside the GEMM (``householder_gemm``); merging absorbs the reflection
into W (``ether_merge``).  ETHER+ (``method="etherplus"``) replaces the
reflection by the rank-2 ``H⁺ = I − ûûᵀ + v̂v̂ᵀ`` per block, on the input
and, two-sided, the output dim (``etherplus_gemm``, ``etherplus_merge``).
``PEFTConfig.backend`` picks the implementation of those ops through
:mod:`repro_torch.core.execute`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import NotPortedError
from repro_torch.core import execute
from repro_torch.core import methods as _methods
from repro_torch.kernels import ref

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PEFTConfig:
    """Configuration for one PEFT method application."""

    method: str = "ether"
    n_blocks: int = 32             # ETHER diagonal blocks (paper default)
    mode: str = "activation"
    # '+'- or '|'-separated regexes of the module paths to adapt
    targets: str = "q_proj+k_proj+v_proj+o_proj+gate_proj+up_proj+down_proj"
    adapter_dtype: str = "float32"
    # ETHER+ on both sides of each linear (paper default; App. D.2 ablates)
    two_sided: bool = True
    # torch (plain), cuda (kernels) or auto (cuda on CUDA tensors)
    backend: str = "auto"

    def __post_init__(self):
        _methods.get(self.method)        # raises NotPortedError
        if self.mode != "activation":
            raise NotPortedError(f"PEFT mode {self.mode!r}")
        if self.backend not in execute.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {execute.BACKENDS}")


def resolve_blocks(n: int, dim: int) -> int:
    """Largest divisor of ``dim`` that is <= n (paper requires n | d)."""
    n = max(1, min(n, dim))
    while dim % n:
        n -= 1
    return n


_unit = ref.unit      # û = u / (‖u‖ + 1e-8) over the last axis


def reflect_activation(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Blockwise ``H_B x = x − 2û(ûᵀx)`` on the last dim of x; u: (n, db).
    The plain math lives beside the kernels in ``kernels/ref.py``."""
    return ref.ref_ether_reflect(x, u)


def reflect_weight(W: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Blockwise ``H_B W`` on the input dim of W: (d, f); u: (n, db)."""
    return ref.ref_ether_merge(W, u)


def etherplus_activation(x: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Blockwise ``H⁺x = x − û(ûᵀx) + v̂(v̂ᵀx)`` on the last dim of x, a
    true rank-2 update (both projections read the original x, not two
    sequential reflections); u, v: (n, db)."""
    return ref.ref_etherplus_reflect(x, u, v)


def etherplus_weight(W: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """Blockwise ``H⁺W`` on the input dim of W (side='left', u, v:
    (n, db) with n·db = d) or ``W H̃⁺`` on its output dim (side='right',
    n·db = f), as one rank-2 update of the original W."""
    if side == "left":
        return ref.ref_etherplus_merge_left(W, u, v)
    if side == "right":
        return ref.ref_etherplus_merge_right(W, u, v)
    raise ValueError(f"side must be 'left' or 'right', got {side!r}")


def adapted_dense(x: torch.Tensor, W: torch.Tensor, b: Optional[torch.Tensor],
                  adapter: Optional[Params],
                  cfg: Optional[PEFTConfig]) -> torch.Tensor:
    """``y = (H_B W)ᵀx + b``; a plain dense layer without an adapter.
    x: (..., d_in); W: (d_in, d_out)."""
    if not adapter or cfg is None:
        y = x @ W.to(x.dtype)
    else:
        y = _methods.get(cfg.method).dense(x, W, adapter, cfg)
    return y if b is None else y + b.to(x.dtype)


def merge_weight(W: torch.Tensor, adapter: Optional[Params],
                 cfg: PEFTConfig) -> torch.Tensor:
    """Absorb the adapter into W — zero-latency inference (paper §3.1)."""
    if adapter is None:
        return W
    return _methods.get(cfg.method).merge(W, adapter, cfg)


def adapter_param_count(method: str, d_in: int, d_out: int,
                        cfg: PEFTConfig) -> int:
    """Trainable parameter count for one adapted linear."""
    return _methods.get(method).param_count(d_in, d_out, cfg)
