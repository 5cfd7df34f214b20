"""PEFT adapter-tree machinery.

Builds, counts and merges adapter trees that mirror a model's parameter
tree.  Stacked weights — the (L, d, f) kernels of the stacked layers —
get adapters with the same leading stack dims, so a layer's slice of the
params and of the adapters are taken together.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch

from repro_torch.common.pytree import flatten_with_paths, map_with_paths
from repro_torch.core import methods as _methods
from repro_torch.core.transforms import (PEFTConfig, adapter_param_count,
                                         merge_weight)

Params = dict[str, Any]


def _target_patterns(cfg: PEFTConfig) -> list[re.Pattern]:
    return [re.compile(p) for p in cfg.targets.split("+") if p]


def is_target(path: str, leaf, cfg: PEFTConfig) -> bool:
    """A leaf is adaptable iff it is a >=2-D 'kernel' whose module name
    matches one of the target patterns."""
    if not path.endswith("/kernel") or getattr(leaf, "ndim", 0) < 2:
        return False
    module = path.rsplit("/", 1)[0]
    return any(p.search(module) for p in _target_patterns(cfg))


def _insert(tree: dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def init_adapters(generator: torch.Generator, params: Params,
                  cfg: Optional[PEFTConfig]) -> Params:
    """Adapter tree mirroring ``params``: at each targeted ``<mod>/kernel``
    the adapter dict lives at ``<mod>``, on the kernel's device.  The
    generator must live on that device too.  Full finetuning has no
    adapters (``{}``), as in the JAX package."""
    if cfg is None or cfg.method == "full":
        return {}
    m = _methods.get(cfg.method)
    adapters: Params = {}
    for path, leaf in flatten_with_paths(params):
        if is_target(path, leaf, cfg):
            d_in, d_out = leaf.shape[-2:]
            _insert(adapters, path.rsplit("/", 1)[0],
                    m.init(generator, d_in, d_out, cfg,
                           tuple(leaf.shape[:-2]), leaf.device))
    return adapters


def adapters_param_count(params: Params, cfg: PEFTConfig) -> int:
    """Trainable adapter parameters for the whole model (paper '#params');
    under full finetuning every parameter of the model."""
    if cfg.method == "full":
        return sum(leaf.numel() for _, leaf in flatten_with_paths(params))
    total = 0
    for path, leaf in flatten_with_paths(params):
        if is_target(path, leaf, cfg):
            stack = 1
            for s in leaf.shape[:-2]:
                stack *= int(s)
            total += stack * adapter_param_count(
                cfg.method, leaf.shape[-2], leaf.shape[-1], cfg)
    return total


def _flatten_adapter_modules(adapters: Params, prefix: str = ""):
    """Yield (module_path, adapter_dict) pairs: an adapter dict is a dict
    whose values are all leaves, e.g. {'u': ...}."""
    if isinstance(adapters, dict) and adapters and all(
            not isinstance(v, dict) for v in adapters.values()):
        yield prefix, adapters
        return
    if isinstance(adapters, dict):
        for k, v in adapters.items():
            yield from _flatten_adapter_modules(
                v, f"{prefix}/{k}" if prefix else k)


@torch.no_grad()
def merge_params(params: Params, adapters: Params,
                 cfg: PEFTConfig) -> Params:
    """Absorb all adapters into the base weights (zero-latency serving).

    A stacked kernel is merged one (d, f) slice per call, as the JAX
    package vmaps ``merge_weight`` over the stack; the result is a new
    tree, ``params`` is not changed."""
    if not adapters:
        return params
    flat_adapters = dict(_flatten_adapter_modules(adapters))

    def _merge_leaf(path: str, kernel):
        mod = path.rsplit("/", 1)[0]
        if mod not in flat_adapters or not path.endswith("/kernel"):
            return kernel
        adapter = flat_adapters[mod]
        stack = kernel.shape[:-2]
        if not stack:
            return merge_weight(kernel, adapter, cfg)
        k2 = kernel.reshape(-1, *kernel.shape[-2:])
        a2 = {k: v.reshape(k2.shape[0], *v.shape[len(stack):])
              for k, v in adapter.items()}
        merged = [merge_weight(k2[i], {k: v[i] for k, v in a2.items()}, cfg)
                  for i in range(k2.shape[0])]
        return torch.stack(merged).reshape(kernel.shape)

    return map_with_paths(_merge_leaf, params)


def get_adapter(adapters: Optional[Params], *keys: str) -> Optional[Params]:
    """Navigate the adapter tree in lockstep with the params tree; returns
    None when the module was not targeted."""
    node = adapters
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def trainable_mask(params: Params, adapters: Params, cfg: PEFTConfig):
    """(base_mask, adapter_mask): which leaves receive gradients and
    updates.  PEFT trains only the float adapter leaves; full finetuning
    (method ``full``) all float base params."""
    if cfg.method == "full":
        return (map_with_paths(lambda _, leaf: leaf.is_floating_point(),
                               params),
                map_with_paths(lambda _, leaf: False, adapters))
    return (map_with_paths(lambda _, leaf: False, params),
            map_with_paths(lambda _, leaf: leaf.is_floating_point(),
                           adapters))
