"""The ETHER transform (ICML 2024) and its in-paper baselines:
configuration, the plain primitives and the entry points.

Conventions, as in the JAX package:

* Weights are stored ``W: (d_in, f_out)`` and dense layers compute
  ``y = x @ W + b``.
* ETHER acts on the input dimension from the left, ``W' = H_B · W``,
  which in row form is ``y = (x @ H_B) @ W`` because H_B is symmetric.
* ``H_B`` is block-diagonal with ``n`` blocks of size ``db = d/n``, kept
  factored as the raw hyperplanes ``u: (n, db)``; the (d × d) transform
  is never built.

Three modes (``PEFTConfig.mode``), as in the JAX package: ``activation``
reflects the activations inside the GEMM (``householder_gemm``);
``weight`` computes ``x @ merge(W, adapter)``, the merge kernels
(``ether_merge``, …) forward and their backwards (``merge_left_bwd``,
``merge_right_bwd``) in training; ``blockgemm`` materialises the n
(db × db) blocks and runs n block GEMMs (paper §3.4) in plain PyTorch.
Merging absorbs the reflection into W (``ether_merge``).  ETHER+
(``method="etherplus"``) replaces the reflection by the rank-2
``H⁺ = I − ûûᵀ + v̂v̂ᵀ`` per block, on the input
and, two-sided, the output dim (``etherplus_gemm``, ``etherplus_merge``).
DeLoRA and HyperAdapt run their own fused GEMM and merge kernels
(``delora_gemm``, ``delora_merge``, ``hyperadapt_gemm``,
``hyperadapt_merge``); OFT, Naive and LoRA are plain PyTorch, as the JAX
package runs them in jnp, and ``full`` is the plain product.
``PEFTConfig.backend`` picks the implementation of the kernel ops through
:mod:`repro_torch.core.execute`.  An adapter that carries ``ids`` is a
request of a multi-tenant :class:`~repro_torch.core.peft.AdapterBank`:
every leaf is the whole bank and ``adapted_dense`` runs the method's
``bank_dense``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import execute
from repro_torch.core import methods as _methods
from repro_torch.kernels import ref

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PEFTConfig:
    """Configuration for one PEFT method application."""

    method: str = "ether"
    n_blocks: int = 32             # ETHER/ETHER+/OFT/Naive diagonal blocks
    rank: int = 8                  # LoRA / DeLoRA rank
    alpha: float = 8.0             # LoRA scale numerator (alpha/rank), DeLoRA λ
    mode: str = "activation"       # activation | weight | blockgemm
    # '+'- or '|'-separated regexes of the module paths to adapt
    targets: str = "q_proj+k_proj+v_proj+o_proj+gate_proj+up_proj+down_proj"
    adapter_dtype: str = "float32"
    # ETHER+ on both sides of each linear (paper default; App. D.2 ablates)
    two_sided: bool = True
    # torch (plain), cuda (kernels) or auto (cuda on CUDA tensors)
    backend: str = "auto"

    def __post_init__(self):
        # UnknownMethodError (a ValueError), or NotPortedError for VeRA
        _methods.get(self.method)
        if self.mode not in ("activation", "weight", "blockgemm"):
            raise ValueError(f"unknown mode {self.mode!r}")
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


def reflect_activation_batched(x: torch.Tensor, u_bank: torch.Tensor,
                               ids: torch.Tensor) -> torch.Tensor:
    """Multi-tenant ``H_B x``: sequence b of x (B, S, d) reflected by
    tenant ids[b] of u_bank (A, n, db), each sequence's hyperplanes
    gathered first, then normalised (O(B·d), not O(A·d)); the registry's
    plain forward of ``ether_reflect_batched``."""
    return ref.ref_ether_reflect_batched(x, u_bank, ids)


def reflect_weight(W: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Blockwise ``H_B W`` on the input dim of W: (d, f); u: (n, db)."""
    return ref.ref_ether_merge(W, u)


def etherplus_activation(x: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Blockwise ``H⁺x = x − û(ûᵀx) + v̂(v̂ᵀx)`` on the last dim of x, a
    true rank-2 update (both projections read the original x, not two
    sequential reflections); u, v: (n, db)."""
    return ref.ref_etherplus_reflect(x, u, v)


def etherplus_activation_batched(x: torch.Tensor, u_bank: torch.Tensor,
                                 v_bank: torch.Tensor,
                                 ids: torch.Tensor) -> torch.Tensor:
    """Multi-tenant ``H⁺x``: sequence b of x (B, S, d) by tenant ids[b] of
    the bank pair (A, n, db), gathered first, then normalised; the
    registry's plain forward of ``etherplus_reflect_batched``."""
    return ref.ref_etherplus_reflect_batched(x, u_bank, v_bank, ids)


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


def _blockify(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., d) -> (..., n, d/n)."""
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def _deblockify(x: torch.Tensor) -> torch.Tensor:
    """(..., n, db) -> (..., n*db)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def householder_blocks(u: torch.Tensor, *, coeff: float = 2.0,
                       sign: float = -1.0) -> torch.Tensor:
    """The n dense (db × db) blocks I + sign·coeff·ûûᵀ (paper-literal; the
    defaults give the Householder reflections).  u: (n, db)."""
    uh = _unit(u)
    eye = torch.eye(u.shape[-1], dtype=uh.dtype, device=uh.device)
    return eye[None] + (sign * coeff) * torch.einsum("ni,nj->nij", uh, uh)


def block_diag_matmul(blocks: torch.Tensor, W: torch.Tensor,
                      side: str = "left") -> torch.Tensor:
    """n block GEMMs in W's dtype: diag(blocks) @ W (side 'left', W
    (n·db, f)) or W @ diag(blocks) (side 'right', W (d, n·db)) — the
    paper's §3.4 scheme.  blocks: (n, db, db)."""
    n, db, _ = blocks.shape
    d, f = W.shape
    if side == "left":
        out = torch.einsum("nij,njf->nif", blocks.to(W.dtype),
                           W.reshape(n, db, f))
    else:
        out = torch.einsum("dni,nij->dnj", W.reshape(d, n, db),
                           blocks.to(W.dtype))
    return out.reshape(d, f)


def materialize_block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """(n, db, db) -> the dense (n·db, n·db) block-diagonal matrix (tests
    and metrics only)."""
    return torch.block_diag(*blocks)


def _addmul(pair) -> torch.Tensor:
    """H⁺'s blocks from its two factored halves: (I − ûûᵀ) + (I + v̂v̂ᵀ)
    − I."""
    hu, hv = pair
    eye = torch.eye(hu.shape[-1], dtype=hu.dtype, device=hu.device)
    return hu + hv - eye[None]


def delora_gemm(x: torch.Tensor, W: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """DeLoRA's jnp primitive ``y = xW + ((x a)·s) b``, every operand cast
    to x's dtype first, as the JAX package computes it (its kernel and the
    port's ``kernels/ref.py`` compute in f32 and round once).  s is the
    method layer's pre-normalised scale.  x: (..., d); W: (d, f); a:
    (d, r); b: (r, f); s: (r,)."""
    y = x @ W.to(x.dtype)
    h = (x @ a.to(x.dtype)) * s.to(x.dtype)
    return y + h @ b.to(x.dtype)


def delora_merge(W: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """Absorb DeLoRA: ``W' = W + (a·s) b`` in W's dtype."""
    return W + (a.to(W.dtype) * s.to(W.dtype)) @ b.to(W.dtype)


def hyperadapt_gemm(x: torch.Tensor, W: torch.Tensor, r: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """HyperAdapt's jnp primitive ``y = ((x·r) W)·c`` in x's dtype.
    r: (d,); c: (f,)."""
    y = (x * r.to(x.dtype)) @ W.to(x.dtype)
    return y * c.to(x.dtype)


def hyperadapt_merge(W: torch.Tensor, r: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """Absorb HyperAdapt: ``W' = diag(r) W diag(c)`` in W's dtype."""
    return W * r.to(W.dtype)[:, None] * c.to(W.dtype)[None, :]


def adapted_dense(x: torch.Tensor, W: torch.Tensor, b: Optional[torch.Tensor],
                  adapter: Optional[Params],
                  cfg: Optional[PEFTConfig]) -> torch.Tensor:
    """``y = (T_L W T_R)ᵀx + ΔWᵀx + b``; a plain dense layer without an
    adapter or under full finetuning.  x: (..., d_in); W: (d_in, d_out).
    With an ``ids`` leaf in the adapter (a bank request), x is (B, S, d_in)
    and sequence b takes tenant ids[b]'s adapter."""
    if not adapter or cfg is None or cfg.method == "full":
        y = x @ W.to(x.dtype)
    elif "ids" in adapter:
        _check_bank_inputs(x, adapter, cfg)
        y = _methods.get(cfg.method).bank_dense(x, W, adapter, cfg)
    else:
        y = _methods.get(cfg.method).dense(x, W, adapter, cfg)
    return y if b is None else y + b.to(x.dtype)


def _check_bank_inputs(x: torch.Tensor, adapter: Params,
                       cfg: PEFTConfig) -> None:
    """The bank forward's inputs, as the JAX package checks them."""
    if cfg.mode != "activation":
        raise ValueError(
            "AdapterBank serving requires mode='activation' "
            f"(got {cfg.mode!r}); merge a single tenant via "
            "bank.select(i) + merge_params instead")
    if x.dim() != 3 or x.shape[0] != adapter["ids"].shape[0]:
        raise ValueError(
            f"bank adapters need per-request (B, S, d) inputs; "
            f"got x {tuple(x.shape)} for ids {tuple(adapter['ids'].shape)}")


def init_adapter(generator: torch.Generator, method: str, d_in: int,
                 d_out: int, cfg: PEFTConfig, *, device=None) -> Params:
    """The trainable adapter parameters of one (d_in × d_out) linear."""
    return _methods.get(method).init(generator, d_in, d_out, cfg, (),
                                     device)


def merge_weight(W: torch.Tensor, adapter: Optional[Params],
                 cfg: PEFTConfig, *, literal: bool = False) -> torch.Tensor:
    """Absorb the adapter into W — zero-latency inference (paper §3.1);
    ``literal`` builds the dense blocks (paper §3.4) where the method has
    them."""
    if adapter is None or cfg.method == "full":
        return W
    return _methods.get(cfg.method).merge(W, adapter, cfg, literal=literal)


def materialize_transform(adapter: Params, cfg: PEFTConfig, d_in: int,
                          d_out: int):
    """Dense (T_left (d_in, d_in) or None, T_right (d_out, d_out) or None)
    for metrics — small dims only; (None, None) for the additive
    methods."""
    return _methods.get(cfg.method).materialize(adapter, cfg, d_in, d_out)


def adapter_param_count(method: str, d_in: int, d_out: int,
                        cfg: PEFTConfig) -> int:
    """Trainable parameter count for one adapted linear."""
    return _methods.get(method).param_count(d_in, d_out, cfg)
