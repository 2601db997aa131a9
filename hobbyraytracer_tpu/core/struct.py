"""Frozen dataclasses that are JAX pytrees.

`@struct.dataclass` turns a class into a frozen dataclass registered with
`jax.tree_util.register_dataclass`: fields are pytree leaves (traced,
differentiated, sharded) unless declared with `struct.field(
pytree_node=False)`, which makes them static metadata — part of the
treedef, so jit specializes on them. Instances get `.replace(**updates)`.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; pytree_node=False marks it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Make `cls` a frozen dataclass and register it as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
