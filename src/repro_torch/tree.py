"""Nested parameter dicts: the port's counterpart of ``jax.tree_util`` for
the trees it handles (dicts of dicts whose leaves are tensors, optimizer
``QLeaf``s or scalars).

A leaf's *path* is the tuple of dict keys leading to it.  :func:`leaves`
walks a tree depth first with the keys of every level sorted, which is
``jax.tree_util``'s order for dicts, so a path list built here lines up
leaf for leaf with the reference's flattened trees.  :func:`leaves_in_order`
keeps each dict's insertion order instead (the optimizer's sums run in the
order the caller built the tree).  Paths print as the reference prints
them: :func:`keystr` (``['layers']['attn']['wq']``) for layout segment
names and :func:`slash` (``layers/attn/wq``) for sharding rules and
checkpoint entries.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple

Path = Tuple[str, ...]


def leaves(tree: Any) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs, keys sorted at every level, depth first."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def leaves_in_order(tree: Any) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in each dict's insertion order, depth first."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def unflatten(items: Iterable[Tuple[Path, Any]]) -> Dict[str, Any]:
    """The nested dict holding each ``leaf`` at its ``path``; dicts are made
    in the order the paths come."""
    root: Dict[str, Any] = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def get(tree: Any, path: Path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure (the first
    tree's insertion order)."""
    return unflatten((p, fn(leaf, *(get(r, p) for r in rest)))
                     for p, leaf in leaves_in_order(tree))


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a dict path: ``['layers']['attn']['wq']``."""
    return "".join(f"[{k!r}]" for k in path)


def slash(path: Path) -> str:
    """The reference's ``/``-joined leaf name: ``layers/attn/wq``."""
    return "/".join(str(k) for k in path)
