"""Trees of tensors: nested dicts and lists, walked in jax's order.

The port keeps parameters, optimizer states and train states as plain
nested dicts and lists (``models.transformer``'s layout).  jax flattens a
dict by its sorted keys and a list in order; these helpers walk the
port's trees the same way, so a checkpoint's leaf ``i`` and a leaf sum
follow one fixed order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_paths(tree, path: Path = (), is_leaf=None
                      ) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, dict keys sorted, lists in order;
    ``is_leaf(node)`` true stops the walk at a node (a spec tuple)."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,), is_leaf)
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` of each leaf of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure;
    ``fn`` is called in :func:`leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(like, values: List[Any]):
    """A tree of ``like``'s structure holding ``values`` in
    :func:`leaves` order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
