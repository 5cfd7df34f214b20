"""Path-addressed helpers over nested dicts of tensors.

The port keeps parameters, adapters and caches as nested dicts, as the
JAX package keeps its pytrees, and addresses a leaf by its '/'-joined
key path, e.g. ``units/pos0/mixer/q_proj/kernel``.  Tuples and lists
(an optimizer chain's state) are nodes too, their items keyed by index
(``opt_state/1/mu/...``), as JAX's tree paths key them.
"""

from __future__ import annotations

from typing import Any, Callable


def path_join(*parts: str) -> str:
    return "/".join(p for p in parts if p)


def flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in insertion order; a leaf is anything but a dict,
    tuple or list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for k, v in items:
        out.extend(flatten_with_paths(v, path_join(prefix, str(k))))
    return out


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, path_join(prefix, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_paths(fn, v, path_join(prefix, str(i)))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
