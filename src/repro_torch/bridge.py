"""Carry the JAX package's weights across to the port.

The tests hold the port against the JAX package on the same numbers:
they build params and adapters with ``repro``, turn them into nested
dicts of numpy arrays, and hand those to :func:`to_torch`.  The layout
needs no change: the port keeps JAX's param paths, its stacked layers
(``units/pos0/...`` with a leading layer axis, ETHER ``u`` as
(L, n, db)) and its (d_in, d_out) kernels.  A whole train state of
``repro.launch.steps.init_state`` carries across too: the optimizer
state's chain tuple stays a tuple, its step counts 0-d int32 tensors.
This module imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.pytree import map_with_paths


def _tensor(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16 (JAX's numpy)
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)   # own, writable copy


def to_torch(tree: Any, device="cpu") -> Any:
    """Nested dicts (and tuples) of numpy arrays → the same nesting of
    torch tensors on ``device``, dtypes and shapes unchanged."""
    return map_with_paths(lambda _, leaf: _tensor(leaf, device), tree)


def bank_to_torch(bank: Any, device="cpu"):
    """A JAX package's AdapterBank (anything with ``tree``, ``tenants`` and
    ``stack_ndims``; its leaves numpy-convertible) → the port's
    :class:`~repro_torch.core.peft.AdapterBank` on ``device``, leaves,
    tenant count and tenant axes unchanged."""
    from repro_torch.core.peft import AdapterBank
    return AdapterBank(to_torch(bank.tree, device), int(bank.tenants),
                       dict(bank.stack_ndims))
