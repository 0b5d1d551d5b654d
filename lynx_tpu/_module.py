"""Pytree module system for lynx-tpu.

The reference implementation (lynx/cheetah) builds its elements and beams on
``torch.nn.Module`` / a half-finished ``eqx.Module`` port and mutates fields
in place (see reference ``lynx/accelerator/element.py:23``).  For a
JAX framework we need every element and beam to be a *pytree* so that the
whole lattice can flow through ``jax.jit`` / ``jax.grad`` / ``jax.vmap`` /
``jax.sharding`` as a single argument.

This module implements a tiny registration system that gives us both worlds:

* Classes are ordinary mutable Python objects, so the reference's ergonomic
  API (``segment.AREAMQZM1.k1 = 2.0``) keeps working *outside* of traced code.
* Every class is registered with ``jax.tree_util`` so a lattice or beam is a
  first-class pytree: array ("data") fields are leaves, configuration
  ("static") fields live in the treedef and therefore participate in
  ``jax.jit`` cache keys.

Subclasses declare their fields::

    class Quadrupole(Element):
        _data_fields = ("length", "k1", "misalignment", "tilt")
        _static_fields = ("name",)

Field declarations are inherited and concatenated along the MRO, so a
subclass only lists the fields it adds.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax


def _collect_fields(cls: type, attr: str) -> Tuple[str, ...]:
    """Collect field names along the MRO (base first), de-duplicated.

    Names listed in a class's ``_exclude_fields`` are dropped (used when a
    subclass turns an inherited stored field into a computed property, e.g.
    ``Segment.length``).
    """
    seen: list[str] = []
    excluded: set[str] = set()
    for klass in reversed(cls.__mro__):
        excluded.update(klass.__dict__.get("_exclude_fields", ()))
        for name in klass.__dict__.get(attr, ()):
            if name not in seen:
                seen.append(name)
    return tuple(name for name in seen if name not in excluded)


class Module:
    """Base class: mutable object that is also a registered JAX pytree.

    ``_data_fields`` become pytree leaves (arrays, or nested Modules);
    ``_static_fields`` become part of the treedef and must be hashable.
    """

    _data_fields: Tuple[str, ...] = ()
    _static_fields: Tuple[str, ...] = ()

    # Resolved (inherited + own) field tuples, filled in by __init_subclass__.
    _all_data_fields: Tuple[str, ...] = ()
    _all_static_fields: Tuple[str, ...] = ()

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        cls._all_data_fields = _collect_fields(cls, "_data_fields")
        cls._all_static_fields = _collect_fields(cls, "_static_fields")
        _register(cls)

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten_with_keys(self):
        children = tuple(
            (jax.tree_util.GetAttrKey(f), getattr(self, f, None))
            for f in type(self)._all_data_fields
        )
        aux = tuple(getattr(self, f, None) for f in type(self)._all_static_fields)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        for name, value in zip(cls._all_data_fields, children):
            object.__setattr__(obj, name, value)
        for name, value in zip(cls._all_static_fields, aux):
            object.__setattr__(obj, name, value)
        return obj

    # -- conveniences ------------------------------------------------------
    def replace(self, **updates: Any):
        """Functional update: return a shallow copy with fields replaced."""
        cls = type(self)
        unknown = set(updates) - set(cls._all_data_fields) - set(
            cls._all_static_fields
        )
        if unknown:
            raise ValueError(f"Unknown fields for {cls.__name__}: {sorted(unknown)}")
        obj = object.__new__(cls)
        for name in cls._all_data_fields + cls._all_static_fields:
            object.__setattr__(
                obj, name, updates.get(name, getattr(self, name, None))
            )
        return obj


def _register(cls: type) -> None:
    try:
        jax.tree_util.register_pytree_with_keys(
            cls,
            cls.tree_flatten_with_keys,
            cls.tree_unflatten,
        )
    except ValueError:
        # Already registered (e.g. class re-created interactively); ignore.
        pass
