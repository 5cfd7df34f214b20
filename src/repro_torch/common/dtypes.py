"""Mixed-precision policy.

Full configs: bf16 params and compute, float32 accumulation inside the
kernels.  Smoke configs (CPU tests): float32 everywhere.  Adapters stay
float32 always: they are tiny and ETHER's unit normalisation is
sensitive to rounding.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config's dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None
