"""PEFT adapter-tree machinery.

Builds, counts and merges adapter trees that mirror a model's parameter
tree.  Stacked weights — the (L, d, f) kernels of the stacked layers —
get adapters with the same leading stack dims, so a layer's slice of the
params and of the adapters are taken together.  :class:`AdapterBank`
stacks many tenants' trees for multi-tenant serving, with the tenant
axis after the stack dims, as in the JAX package; its ``MergedCache``
sibling and ``to_device`` (the serve engine's hot tier and mesh
placement) wait for the engine (ROADMAP.md).
"""

from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np
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


def _module(tree: Params, path: str) -> Params:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


class AdapterBank:
    """N tenants' adapter trees stacked for multi-tenant serving.

    Each module's adapter leaves carry the tenant axis at position
    ``stack_ndims[module]``, after the module's param stack dims: a
    stacked (L, n, db) ETHER ``u`` becomes (L, A, n, db), so the backbone
    slices layers as it slices the params and each layer sees its whole
    (A, n, db) bank.  Only the methods flagged ``bank_servable`` stack
    (ETHER's u; ETHER+'s u1/v1/u2/v2; DeLoRA's a, b and λ; HyperAdapt's
    r and c).  Every operation returns a new bank or tree; none changes
    this one's tensors."""

    BANK_METHODS = _methods.bank_servable()

    def __init__(self, tree: Params, tenants: int,
                 stack_ndims: dict[str, int]):
        self.tree = tree
        self.tenants = tenants
        self.stack_ndims = stack_ndims

    @classmethod
    def stack(cls, trees: list, params: Params,
              cfg: PEFTConfig) -> "AdapterBank":
        """Stack N standard adapter trees (each mirroring ``params``)."""
        if cfg.method not in cls.BANK_METHODS:
            raise ValueError(f"AdapterBank supports {cls.BANK_METHODS} "
                             f"only (got {cfg.method!r})")
        if not trees:
            raise ValueError("need at least one tenant tree")
        stack_ndims = {
            path.rsplit("/", 1)[0]: leaf.ndim - 2
            for path, leaf in flatten_with_paths(params)
            if is_target(path, leaf, cfg)}
        bank: Params = {}
        for mod, adapter in _flatten_adapter_modules(trees[0]):
            nd = stack_ndims[mod]
            _insert(bank, mod, {
                k: torch.stack([_module(t, mod)[k] for t in trees], dim=nd)
                for k in adapter})
        return cls(bank, len(trees), stack_ndims)

    def _map(self, fn) -> Params:
        """A tree of ``fn(leaf name, leaf, tenant axis)`` per leaf."""
        out: Params = {}
        for mod, adapter in _flatten_adapter_modules(self.tree):
            nd = self.stack_ndims[mod]
            _insert(out, mod, {k: fn(mod, k, v, nd)
                               for k, v in adapter.items()})
        return out

    def with_capacity(self, capacity: int,
                      method: Optional[str] = None) -> "AdapterBank":
        """Pad the tenant axis to ``capacity`` rows.  With ``method`` the
        new rows hold the method's identity adapter
        (``methods.identity_like`` values: ones for HyperAdapt's scales),
        without it zeros."""
        if capacity < self.tenants:
            raise ValueError(f"capacity {capacity} < resident tenants "
                             f"{self.tenants}")
        if capacity == self.tenants:
            return self
        m = _methods.get(method) if method is not None else None
        pad = capacity - self.tenants

        def padded(mod, k, v, nd):
            block = v.new_zeros((*v.shape[:nd], pad, *v.shape[nd + 1:]))
            if m is not None:
                block = m.identity_leaf(k, block)
            return torch.cat([v, block], dim=nd)
        return AdapterBank(self._map(padded), capacity, self.stack_ndims)

    def replace_slot(self, slot: int, adapters: Params) -> "AdapterBank":
        """A new bank whose tenant row ``slot`` holds ``adapters`` (a
        standard single-tenant tree); every other row, and this bank, are
        untouched.  ``slot`` is clamped into [0, tenants), as the JAX
        package's ``dynamic_update_slice`` clamps its start."""
        slot = min(max(int(slot), 0), self.tenants - 1)

        def swapped(mod, k, v, nd):
            out = v.clone()
            out.select(nd, slot).copy_(_module(adapters, mod)[k])
            return out
        return AdapterBank(self._map(swapped), self.tenants,
                           self.stack_ndims)

    def select(self, tenant: int) -> Params:
        """One tenant's standard adapter tree (e.g. for merge_params)."""
        return self._map(lambda mod, k, v, nd: v.select(nd, tenant)
                         .contiguous())

    def request(self, ids) -> Params:
        """The adapter tree of one batch of requests: every module keeps
        its whole bank and gains an ``ids`` leaf, int32 on the bank's
        device, broadcast over the module's stack dims so the backbone
        slices it with the layers; ``adapted_dense`` then runs the
        method's bank forward.  Ids outside [0, tenants) are mapped into
        it by the bank kernels (from the end if negative, then clamped),
        as the JAX package's gather maps them:
        frontends call :func:`validate_tenant_ids` first."""
        some = next(iter(next(_flatten_adapter_modules(self.tree))[1]
                         .values()))
        ids = torch.as_tensor(ids).to(device=some.device, dtype=torch.int32)

        def with_ids(mod, adapter):
            nd = self.stack_ndims[mod]
            stack = next(iter(adapter.values())).shape[:nd]
            return {**adapter, "ids": ids.expand(*stack, *ids.shape)}
        out: Params = {}
        for mod, adapter in _flatten_adapter_modules(self.tree):
            _insert(out, mod, with_ids(mod, adapter))
        return out

    def size_bytes(self) -> int:
        """Device bytes of the whole bank."""
        return sum(leaf.numel() * leaf.element_size()
                   for _, a in _flatten_adapter_modules(self.tree)
                   for leaf in a.values())


def validate_tenant_ids(ids, tenants: int) -> np.ndarray:
    """Host-side guard for serving frontends: raise on any id outside
    ``[0, tenants)`` instead of letting the bank kernels map it to a
    neighbour's adapter (a bad id would otherwise be served tenant
    ``tenants - 1``'s weights).  Returns the ids as int32 numpy.  The
    errors are the JAX package's."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    arr = np.asarray(ids)
    if arr.size and not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"tenant ids must be integers, got {arr.dtype}")
    bad = arr[(arr < 0) | (arr >= tenants)] if arr.size else arr
    if bad.size:
        raise ValueError(f"tenant id(s) {sorted(set(bad.tolist()))} out "
                         f"of range [0, {tenants})")
    return arr.astype(np.int32)


def init_adapter_bank(seed: int, params: Params, cfg: PEFTConfig,
                      tenants: int) -> AdapterBank:
    """``tenants`` independent adapter trees, stacked.  Tenant t's tree
    comes from a ``torch.Generator`` of its own on the params' device,
    seeded from the t-th child of ``numpy.random.SeedSequence(seed)``."""
    device = next(leaf for _, leaf in flatten_with_paths(params)).device
    seeds = [int(c.generate_state(1)[0])
             for c in np.random.SeedSequence(seed).spawn(tenants)]
    trees = [init_adapters(torch.Generator(device=device).manual_seed(sd),
                           params, cfg) for sd in seeds]
    return AdapterBank.stack(trees, params, cfg)


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
