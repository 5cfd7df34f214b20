"""The train step of the port and its state, for one device.

State layout, as the JAX package's ``repro.launch.steps``:
``{"params", "adapters", "opt_state", "step"}``.  In PEFT mode (the
paper's) gradients and the optimizer touch only the adapter tree; the
base params carry ``requires_grad=False`` and flow through untouched.
Under full finetuning (method ``full``, the JAX package's
``full_finetune``) they touch the base params and there are no adapters.
Sharding (the JAX package's ``*_shardings``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.common.pytree import flatten_with_paths, map_with_paths
from repro_torch.core.peft import init_adapters, trainable_mask
from repro_torch.core.transforms import PEFTConfig
from repro_torch.models.api import init_model, resolve_device, train_loss
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
    ``grad_norm``), left for the caller to read back."""
    key = "params" if _full(peft) else "adapters"

    def step(state: Params, batch: dict):
        loss, metrics = train_loss(state["params"], state["adapters"], batch,
                                   cfg, peft)
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

    return step
