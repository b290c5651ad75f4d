"""Parameter trees: dicts, lists and tuples of tensors (the port's form of
the JAX package's pytrees)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply fn leaf by leaf over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in the order tree_map visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
