"""Parameter trees: dicts of dataclasses and tensors.

The port's stand-in for the few ``jax.tree_util`` calls that the
differentiable step and checkpoints need.  A tree is a ``dict`` (walked in
sorted key order, as JAX flattens dicts), a dataclass (walked in field
order) or a leaf.  Key paths are written as JAX writes them
(``"['materials']/.kd"``), so checkpoints name their leaves alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``[(key path, leaf), ...]`` in JAX's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            sub = f"['{k}']"
            out += leaves_with_paths(tree[k], f"{path}/{sub}" if path else sub)
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            sub = f".{f.name}"
            out += leaves_with_paths(getattr(tree, f.name),
                                     f"{path}/{sub}" if path else sub)
        return out
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def unflatten(like: Any, values: list) -> Any:
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    n = len(leaves(like))
    if len(values) != n:
        raise ValueError(f"{len(values)} values for {n} leaves")
    it = iter(values)
    return tree_map(lambda _: next(it), like)
