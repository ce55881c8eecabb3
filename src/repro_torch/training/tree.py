"""The nested dict / list trees of the port (params, optimizer moments)
walked in the JAX package's pytree order: dict keys sorted, lists,
tuples and NamedTuples in order.  A leaf's path is the tuple of its keys,
indices and NamedTuple field names, as ``jax.tree_util``'s key paths
name them."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def leaves_with_path(tree: Any, path: Tuple = ()) -> Iterator[tuple]:
    """(path, leaf) pairs in the JAX package's flatten order; None is an
    empty subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, v in zip(names, tree):
            yield from leaves_with_path(v, path + (name,))
    else:
        yield path, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result keeps ``tree``'s
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)
