"""LatticeJSON save/load — file-compatible with Cheetah's flavor.

Format (reference ``lynx/latticejson.py``): a JSON document with metadata
(``"version": "cheetah-0.6"``), an ``elements`` dict ``{name: [ClassName,
params]}`` and a ``lattices`` dict of name -> cell lists, supporting nested
sub-segments.  Files written by Cheetah load here and vice versa.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

import lynx_tpu


def feature_to_plain(value: Any) -> Any:
    """Convert a feature value to a JSON-serializable plain type."""
    if isinstance(value, jax.Array):
        return value.tolist()
    if isinstance(value, tuple):
        return list(value)
    return value


def plain_to_feature(value: Any) -> Any:
    """Convert a plain JSON value back to an array where appropriate."""
    return value if isinstance(value, (str, bool)) else jnp.asarray(value)


#: Feature keys that stay host-side (static configuration, not physics).
_HOST_KEYS = frozenset({"resolution", "binning", "shape", "is_active"})


class _PackedParams:
    """One-shot device upload of every numeric lattice parameter.

    Every host->device transfer has a fixed cost; a large lattice has
    thousands of tiny parameters, so naive per-parameter ``jnp.asarray``
    pays it thousands of times.  Packing every value
    into one padded (N, max_size) array costs ONE transfer; elements then
    receive on-device rows via a single compiled gather dispatched N times.
    """

    def __init__(self, lattice_dict: dict, dtype=jnp.float32):
        import numpy as np

        values: list = []
        specs: list = []  # (row, shape)
        self._index: dict = {}
        for element_name, (_, params) in lattice_dict["elements"].items():
            for key, value in params.items():
                if isinstance(value, (str, bool)) or key in _HOST_KEYS:
                    continue
                array = np.asarray(value, dtype=np.float32)
                self._index[(element_name, key)] = len(values)
                specs.append(array.shape)
                values.append(array.ravel())
        self._arrays: list = []
        if values:
            max_size = max(v.size for v in values)
            packed = np.zeros((len(values), max_size), dtype=np.float32)
            for row, value in enumerate(values):
                packed[row, : value.size] = value
            device = jnp.asarray(packed, dtype=dtype)  # ONE transfer

            def unpack(table):
                out = []
                for row, shape in enumerate(specs):
                    size = 1
                    for dim in shape:
                        size *= dim
                    out.append(table[row, :size].reshape(shape))
                return out

            # ONE compile + ONE dispatch for all parameters.
            self._arrays = jax.jit(unpack)(device)

    def get(self, element_name: str, key: str, value: Any) -> Any:
        """On-device array for a packed parameter, or the plain value."""
        if isinstance(value, (str, bool)) or key in _HOST_KEYS:
            # Static configuration stays host-side: converting e.g. a screen
            # ``resolution`` with ``jnp.asarray`` would stage it as a traced
            # constant when the lattice is loaded inside ``jit``, breaking
            # ``int()``-based shape configuration in element constructors.
            return value
        if (element_name, key) not in self._index:
            return jnp.asarray(value)
        return self._arrays[self._index[(element_name, key)]]


#: defining_features names that do not match the constructor-argument /
#: attribute name directly.
_FEATURE_ATTR_ALIASES = {"transfer_map": "_transfer_map"}


def convert_element(element: "lynx_tpu.Element") -> Tuple[str, str, dict]:
    """Deconstruct an element into (name, class name, parameter dict)."""
    params = {}
    for feature in element.defining_features:
        attr = _FEATURE_ATTR_ALIASES.get(feature, feature)
        params[feature] = feature_to_plain(getattr(element, attr))
    return element.name, element.__class__.__name__, params


def convert_segment(segment: "lynx_tpu.Segment") -> Tuple[dict, dict]:
    """Deconstruct a segment into elements and lattices dicts (recursive)."""
    elements: dict = {}
    lattices: dict = {}
    cell = []
    for element in segment.elements:
        if isinstance(element, lynx_tpu.Segment):
            sub_elements, sub_lattices = convert_segment(element)
            elements.update(sub_elements)
            lattices.update(sub_lattices)
            element_name = element.name
        else:
            element_name, element_class, element_params = convert_element(element)
            elements[element_name] = [element_class, element_params]
        cell.append(element_name)
    lattices[segment.name] = cell
    return elements, lattices


def save_cheetah_model(
    segment: "lynx_tpu.Segment",
    filename: str,
    title: Optional[str] = None,
    info: str = "This is a placeholder lattice description",
) -> None:
    """Save a segment as LatticeJSON (Cheetah-compatible ``version`` tag)."""
    if title is None:
        title = segment.name if segment.name is not None else "Unnamed Lattice"

    lattice_dict = {
        "version": "cheetah-0.6",
        "title": title,
        "info": info,
        "root": segment.name if segment.name is not None else "cell",
    }
    elements, lattices = convert_segment(segment)
    lattice_dict["elements"] = elements
    lattice_dict["lattices"] = lattices

    with open(filename, "w") as f:
        f.write(json.dumps(lattice_dict, cls=CompactJSONEncoder, indent=4))


class CompactJSONEncoder(json.JSONEncoder):
    """JSON encoder that only indents the first two levels (keeps lattice
    files human-scannable; format from nobeam/latticejson)."""

    def encode(self, obj, level=0):
        if isinstance(obj, dict) and level < 2:
            items_indent = (level + 1) * self.indent * " "
            items_string = ",\n".join(
                f"{items_indent}{json.dumps(key)}: {self.encode(value, level=level + 1)}"
                for key, value in obj.items()
            )
            dict_indent = level * self.indent * " "
            newline = "\n" if level == 0 else ""
            return f"{{\n{items_string}\n{dict_indent}}}{newline}"
        return json.dumps(obj)


def parse_element(
    name: str, lattice_dict: dict, packed: Optional[_PackedParams] = None
) -> "lynx_tpu.Element":
    """Reconstruct one element from the ``elements`` table."""
    class_name, params = lattice_dict["elements"][name]
    element_class = getattr(lynx_tpu, class_name)
    if packed is not None:
        converted = {
            key: packed.get(name, key, value) for key, value in params.items()
        }
    else:
        converted = {
            key: value if key in _HOST_KEYS else plain_to_feature(value)
            for key, value in params.items()
        }
    return element_class(name=name, **converted)


def parse_segment(
    name: str, lattice_dict: dict, packed: Optional[_PackedParams] = None
) -> "lynx_tpu.Segment":
    """Reconstruct a segment (recursively resolving nested lattices)."""
    elements = []
    for element_name in lattice_dict["lattices"][name]:
        if element_name in lattice_dict["lattices"]:
            elements.append(parse_segment(element_name, lattice_dict, packed))
        else:
            elements.append(parse_element(element_name, lattice_dict, packed))
    return lynx_tpu.Segment(elements=elements, name=name)


def load_cheetah_model(filename: str) -> "lynx_tpu.Segment":
    """Load a lattice from a LatticeJSON file (batched device upload)."""
    with open(filename, "r") as f:
        lattice_dict = json.load(f)
    packed = _PackedParams(lattice_dict)
    return parse_segment(lattice_dict["root"], lattice_dict, packed)
