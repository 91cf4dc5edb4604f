"""Nested dict/list/tuple trees of tensors and numbers: the one walker that
the optimizer, the checkpoints, the stacked identities and the sampler's
adapters share, so that they all see the leaves in the same order.

Leaves come in insertion order, dict by dict and index by index. A None
is an empty subtree, as in JAX: it has no leaves and maps to None. Paths
are JAX's key paths joined by "/" (dict keys, sequence indices), the keys
of a checkpoint's `state.npz`.
"""

from __future__ import annotations

from typing import Callable, List, Tuple


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _walk(fn: Callable, path: str, node, rest: tuple):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _walk(fn, _join(path, k), v, tuple(r[k] for r in rest)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        if any(len(r) != len(node) for r in rest):
            raise ValueError(f"trees of different lengths at {path or 'the root'}")
        out = [_walk(fn, _join(path, i), v, tuple(r[i] for r in rest)) for i, v in enumerate(node)]
        return tuple(out) if isinstance(node, tuple) else out
    return fn(path, node, *rest)


def tree_map_with_path(fn: Callable, tree, *rest):
    """`fn(path, leaf, *leaves of rest)` over the leaves of `tree`, in its
    structure; `rest` are trees of the same structure."""
    return _walk(fn, "", tree, rest)


def tree_map(fn: Callable, tree, *rest):
    """`fn(leaf, *leaves of rest)` over the leaves of `tree`, in its structure."""
    return _walk(lambda _, *leaves: fn(*leaves), "", tree, rest)


def tree_paths(tree) -> List[Tuple[str, object]]:
    """[(path, leaf)] in leaf order."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def tree_leaves(tree) -> list:
    """The leaves in order."""
    return [leaf for _, leaf in tree_paths(tree)]
