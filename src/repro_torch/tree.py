"""Trees of tensors: named tuples, dicts, tuples and lists of tensors.

The port's counterpart of the ``jax.tree`` calls the reference makes on
client state: a TM client is a named tuple of tensors, an MLP client a
dict, a FLIS client a named tuple holding a dict.  ``None`` is an empty
subtree, as in jax.  ``is_leaf`` stops the walk at a subtree, as jax's
does (the sharding rules take a decode cache whole).
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def map(fn: Callable[..., Any], tree: Any, *rest: Any,  # noqa: A001
        is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``jax.tree.map``: ``fn`` on the tensors of ``tree`` and the
    matching leaves of ``rest``, which share its structure."""
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest,
                         is_leaf=is_leaf)


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                  is_leaf: Callable[[Any], bool] | None = None,
                  _path: tuple = ()) -> Any:
    """``jax.tree_util.tree_map_with_path``: ``fn(path, leaf, *rest)``,
    ``path`` the keys from the root to the leaf: dict keys, sequence
    indices and named-tuple field names, the entries of jax's key paths
    (``("segments", 0, 0, "mixer", "wq")``)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor) or (is_leaf is not None
                                          and is_leaf(tree)):
        return fn(_path, tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            map_with_path(fn, *parts, is_leaf=is_leaf, _path=_path + (k,))
            for k, *parts in zip(tree._fields, tree, *rest)))
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 is_leaf=is_leaf, _path=_path + (k,))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            map_with_path(fn, *parts, is_leaf=is_leaf, _path=_path + (i,))
            for i, *parts in zip(range(len(tree)), tree, *rest))
    raise TypeError(f"tree: a {type(tree).__name__} is not a tensor, a "
                    f"named tuple, a dict, a tuple or a list")


def leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None
           ) -> list[Any]:
    """The tensors of ``tree`` in the order :func:`map` visits them."""
    out: list[Any] = []
    map(out.append, tree, is_leaf=is_leaf)
    return out
