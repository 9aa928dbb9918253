"""The port's parameter trees: nested dicts and lists of tensors.

The reference leans on ``jax.tree`` for its parameters, optimizer states
and checkpoints; these helpers do the same for the port's trees.  Leaves
come in a fixed order (dict insertion order, list order), so trees built
from one another by :func:`map_tree` line up leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, *vs) for vs in zip(tree, *rest)]
    return fn(tree, *rest)


def with_leaves(tree, values: List[Any]):
    """A tree of ``tree``'s structure holding ``values`` in leaf order."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves keyed by their path, its parts joined by ``/``: list
    entries by their index (``layers/0/mixer/wq``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: Dict[str, Any]):
    """Inverse of :func:`flatten`: a level whose keys are 0..n-1 becomes
    a list, any other a dict."""
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [build(node[str(i)]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}
    return build(root)
