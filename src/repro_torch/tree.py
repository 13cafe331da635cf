"""Trees of tensors: named tuples, dicts, tuples and lists of tensors.

The port's counterpart of the ``jax.tree`` calls the reference makes on
client state: a TM client is a named tuple of tensors, an MLP client a
dict, a FLIS client a named tuple holding a dict.  ``None`` is an empty
subtree, as in jax.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``jax.tree.map``: ``fn`` on the tensors of ``tree`` and the
    matching leaves of ``rest``, which share its structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map(fn, *parts) for parts in zip(tree, *rest)))
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(fn, *parts) for parts in zip(tree, *rest))
    raise TypeError(f"tree: a {type(tree).__name__} is not a tensor, a "
                    f"named tuple, a dict, a tuple or a list")


def leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of ``tree`` in the order :func:`map` visits them."""
    out: list[torch.Tensor] = []
    map(out.append, tree)
    return out
