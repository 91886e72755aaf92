"""JAX (flax) parameter tree -> this package's torch ``state_dict``.

The flax module names of the JAX package equal the DiffBIR torch checkpoint
key fragments, so a flax leaf path joined with '.' is the torch key; only
the leaf name and the layout change, by the rules of
``diffbir_tpu/weights/convert.py::flax_to_torch_state_dict``:

- ``kernel`` -> ``weight``: conv HWIO -> OIHW, dense (I, O) -> (O, I)
- ``scale`` / ``embedding`` -> ``weight``
- ``in_proj_weight`` (d, 3d) -> (3d, d)
- ``params`` collection keys are dropped.

The tree is plain nested dicts of numpy arrays (``jax.device_get`` of a flax
tree), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, path + (key,))
        else:
            yield path + (key,), val


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax path (without 'params') -> (torch key, transpose?)."""
    *mods, leaf = path
    name = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
    return ".".join([*mods, name]), leaf in ("kernel", "in_proj_weight")


def convert_leaf(path: Tuple[str, ...], leaf) -> Tuple[str, np.ndarray]:
    """One flax leaf -> (torch key, fp32 array in torch layout; a view where
    the layout allows)."""
    key, transpose = _torch_key(tuple(p for p in path if p != "params"))
    v = np.asarray(leaf, dtype=np.float32)
    if transpose:
        if v.ndim == 4:  # HWIO -> OIHW
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:
            v = v.T
    return key, v


def flax_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays (a flax variable tree, or a dict of such trees
    keyed by submodule name) -> {torch key: fp32 tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        key, v = convert_leaf(path, leaf)
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out
