"""Composable gradient transformations on nested dicts of tensors, the
JAX package's optax-style protocol (``repro.optim.transforms``):

    init(params) -> state
    update(grads, state, params) -> (updates, state)

The state is made of tensors on the params' device (moments float32,
step counts 0-d int32), so an update runs without a host sync.  Updates
are functional: nothing is changed in place, which keeps a step's result
a pure function of its inputs (the trainer's bitwise resume relies on
it).  ``torch.optim.AdamW`` is not used: the reference clips by global
norm before Adam and reads the schedule at the pre-increment count.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.common.pytree import flatten_with_paths, map_with_paths


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def _map(fn, tree, *rest):
    """Map ``fn`` over the float leaves of ``tree`` (and the leaves at the
    same paths of ``rest``); other leaves pass through unchanged."""
    others = [dict(flatten_with_paths(r)) for r in rest]

    def g(path, x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        return fn(x, *(o[path] for o in others))
    return map_with_paths(g, tree)


def _count(params) -> torch.Tensor:
    leaves = [x for _, x in flatten_with_paths(params)
              if isinstance(x, torch.Tensor)]
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(tree) -> torch.Tensor:
    sq = [x.float().square().sum() for _, x in flatten_with_paths(tree)
          if isinstance(x, torch.Tensor) and x.is_floating_point()]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params=None):
        factor = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
        return _map(lambda g: g * factor, grads), state
    return GradientTransformation(init, update)


def scale_by_schedule(schedule) -> GradientTransformation:
    """Multiply by −lr, the schedule read at the count before this step
    (so with warmup the first update is 0)."""
    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params=None):
        lr = schedule(state["count"])
        return (_map(lambda g: g * -lr, grads),
                {"count": state["count"] + 1})
    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"mu": _map(zeros, params), "nu": _map(zeros, params),
                "count": _count(params)}

    def update(grads, state, params=None):
        count = state["count"] + 1           # bias correction counts from 1
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                  state["mu"], grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                  state["nu"], grads)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        upd = _map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps),
                   mu, nu)
        return upd, {"mu": mu, "nu": nu, "count": count}
    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Callable[[str], bool]] = None
                        ) -> GradientTransformation:
    """AdamW-style decoupled weight decay.  ``mask`` maps leaf path →
    bool (decay or not); by default every ≥2-D leaf decays."""
    def init(params):
        return ()

    def update(grads, state, params=None):
        if weight_decay == 0.0 or params is None:
            return grads, state
        pmap = dict(flatten_with_paths(params))

        def add_wd(path, g):
            p = pmap.get(path)
            if p is None or not g.is_floating_point():
                return g
            decay = mask(path) if mask is not None else p.dim() >= 2
            return g + weight_decay * p.to(g.dtype) if decay else g
        return map_with_paths(add_wd, grads), state
    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s2 = t.update(grads, s, params)
            new_state.append(s2)
        return grads, tuple(new_state)
    return GradientTransformation(init, update)


def adamw(schedule, *, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          clip_norm: Optional[float] = 1.0,
          wd_mask=None) -> GradientTransformation:
    """The default PEFT optimizer: clip → Adam → (decay) → −lr.  Paper
    App. C.4: ETHER sets wd = 0 (the hyperplane normalisation makes decay
    a no-op on direction)."""
    parts = []
    if clip_norm is not None:
        parts.append(clip_by_global_norm(clip_norm))
    parts.append(scale_by_adam(b1, b2, eps))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay, wd_mask))
    parts.append(scale_by_schedule(schedule))
    return chain(*parts)


def apply_updates(params, updates):
    """params + updates in float32, rounded to each param's dtype."""
    return _map(lambda p, u: (p.float() + u.float()).to(p.dtype), params,
                updates)
