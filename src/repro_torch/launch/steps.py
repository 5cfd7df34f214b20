"""The train step of the port and its state, for one device.

State layout, as the JAX package's ``repro.launch.steps``:
``{"params", "adapters", "opt_state", "step"}``.  In PEFT mode (the
paper's) gradients and the optimizer touch only the adapter tree; the
base params carry ``requires_grad=False`` and flow through untouched.
Under full finetuning (method ``full``, the JAX package's
``full_finetune``) they touch the base params and there are no adapters.
Training through a multi-tenant adapter bank (:func:`make_bank_state`,
:func:`make_bank_train_step`) keeps ``{"params", "bank", "opt_state",
"step"}``, the bank's stacked tree in place of the adapters.  Sharding
(the JAX package's ``*_shardings``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.common.pytree import flatten_with_paths, map_with_paths
from repro_torch.core.peft import AdapterBank, init_adapters, trainable_mask
from repro_torch.core.transforms import PEFTConfig
from repro_torch.models.api import init_model, resolve_device, train_loss
from repro_torch.models.backbone import check_trainable
from repro_torch.optim import (GradientTransformation, apply_updates,
                               global_norm)

Params = dict[str, Any]


def _set_trainable(tree: Params, mask: Params) -> Params:
    """Mark each leaf trainable (a leaf of autograd) as ``mask`` says."""
    flags = dict(flatten_with_paths(mask))
    return map_with_paths(lambda p, x: x.requires_grad_(flags[p]), tree)


def _full(peft: Optional[PEFTConfig]) -> bool:
    return peft is not None and peft.method == "full"


def init_state(cfg, peft: PEFTConfig, opt: GradientTransformation, *,
               seed: int = 0, device="cuda") -> Params:
    """Random params from ``seed``, adapters from ``seed + 1`` (as the
    serving CLI makes them), the optimizer state of what trains and step
    0, all on ``device``."""
    dev = resolve_device(device)
    params = init_model(cfg, seed=seed, device=dev)
    adapters = init_adapters(torch.Generator(device=dev).manual_seed(seed + 1),
                             params, peft)
    return make_state(params, adapters, peft, opt)


def make_state(params: Params, adapters: Params, peft: PEFTConfig,
               opt: GradientTransformation) -> Params:
    """The train state of given params and adapters at step 0."""
    base_mask, adapter_mask = trainable_mask(params, adapters, peft)
    params = _set_trainable(params, base_mask)
    adapters = _set_trainable(adapters, adapter_mask)
    dev = next(x for _, x in flatten_with_paths(params)).device
    return {"params": params, "adapters": adapters,
            "opt_state": opt.init(params if _full(peft) else adapters),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_train_step(cfg, peft: Optional[PEFTConfig],
                    opt: GradientTransformation):
    """(state, batch) → (state, metrics): loss, backward, and the
    optimizer on the adapter tree (the base params under full
    finetuning).  ``batch`` holds (B, S) ``tokens`` and ``labels`` tensors
    on the state's device; ``metrics`` are 0-d device tensors (``loss``,
    ``grad_norm``), left for the caller to read back.  Raises
    NotPortedError for a config the port does not train (Mamba-2)."""
    check_trainable(cfg)
    key = "params" if _full(peft) else "adapters"

    def step(state: Params, batch: dict):
        loss, metrics = train_loss(state["params"], state["adapters"], batch,
                                   cfg, peft)
        return _update(state, key, loss, metrics, opt)

    return step


def _update(state: Params, key: str, loss: torch.Tensor, metrics: dict,
            opt: GradientTransformation):
    """The step after the loss: the gradient of ``loss`` over every leaf
    of ``state[key]``, the optimizer on them, and the next state with its
    metrics (``grad_norm`` added)."""
    tree = state[key]
    flat = flatten_with_paths(tree)     # every leaf of it trains
    by_path = dict(zip((p for p, _ in flat), torch.autograd.grad(
        loss, [a for _, a in flat])))
    grads = map_with_paths(lambda p, _: by_path[p], tree)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, state["opt_state"], tree)
        new_tree = apply_updates(tree, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
    new_tree = map_with_paths(lambda _, x: x.requires_grad_(), new_tree)
    return dict(state, **{key: new_tree}, opt_state=opt_state,
                step=state["step"] + 1), metrics


def make_bank_state(params: Params, bank: AdapterBank,
                    opt: GradientTransformation) -> Params:
    """The train state of an adapter bank at step 0: ``{"params"`` (frozen),
    ``"bank"`` (``bank.tree``, every leaf trainable), ``"opt_state"``,
    ``"step"}``, on the params' device."""
    params = map_with_paths(lambda _, x: x.requires_grad_(False), params)
    tree = map_with_paths(lambda _, x: x.requires_grad_(), bank.tree)
    dev = next(x for _, x in flatten_with_paths(params)).device
    return {"params": params, "bank": tree, "opt_state": opt.init(tree),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_bank_train_step(cfg, peft: PEFTConfig, opt: GradientTransformation,
                         bank: AdapterBank):
    """(state, batch, ids) → (state, metrics) over a :func:`make_bank_state`
    state: the loss of ``train_loss(params, bank.request(ids), batch)``
    (each sequence b through tenant ids[b]'s adapters, activation mode),
    its gradient over every leaf of the bank and the optimizer on them —
    what the JAX package does with ``jax.value_and_grad`` over
    ``bank.tree``.  A tenant no id names gets a zero gradient (AdamW's
    weight decay still moves it).  ``bank`` gives the tenant count and the
    stack dims.  Raises NotPortedError for a config the port does not
    train (Mamba-2)."""
    check_trainable(cfg)

    def step(state: Params, batch: dict, ids):
        current = AdapterBank(state["bank"], bank.tenants, bank.stack_ndims)
        loss, metrics = train_loss(state["params"], current.request(ids),
                                   batch, cfg, peft)
        return _update(state, "bank", loss, metrics, opt)

    return step
