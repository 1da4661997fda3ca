"""One walk over trees of tensors: dataclasses, named tuples, tuples,
lists and dicts (the port's counterpart of ``jax.tree_util``)."""

from __future__ import annotations

import dataclasses

import torch


def map_tensors(fn, tree, path: str = ""):
    """``tree`` rebuilt with ``fn(path, tensor)`` in place of every tensor;
    other leaves are kept.  Paths read like ``jax``'s ``keystr``
    (``.field``, ``[0]``, ``['key']``)."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name), f"{path}.{f.name}")
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, x, f"{path}.{name}")
                            for name, x in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, x, f"{path}[{i}]")
                          for i, x in enumerate(tree))
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    return tree


def tensor_leaves(tree) -> list:
    """``(path, tensor)`` for every tensor of ``tree``, in walk order."""
    out = []

    def visit(path, t):
        out.append((path, t))
        return t

    map_tensors(visit, tree)
    return out
