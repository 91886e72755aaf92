"""JAX (flax) parameter tree -> this package's torch ``state_dict``.

The flax module names of the JAX package equal the DiffBIR torch checkpoint
key fragments, so a flax leaf path joined with '.' is the torch key; only
the leaf name and the layout change, by the rules of
``diffbir_tpu/weights/convert.py::flax_to_torch_state_dict``:

- ``kernel`` -> ``weight``: conv HWIO -> OIHW, dense (I, O) -> (O, I)
- ``scale`` / ``embedding`` -> ``weight``
- ``in_proj_weight`` (d, 3d) -> (3d, d)
- ``params`` collection keys are dropped.

A quantised scope (the JAX int8 serving layout: a dict holding ``kernel_q``)
keeps its tensors in the JAX layout, so the int8 kernels of both packages
read one tensor:

- ``kernel_q`` -> ``weight_q``, int8, unchanged: [K, N] for a dense site
  (``QuantLinear``), HWIO (3, 3, Cin, Cout) or (1, 1, Cin, Cout) for a conv
  (``QuantConv``);
- ``scale`` -> ``weight_scale``, fp32 [N] (one per output channel);
- ``bias`` -> ``bias``.

Every other leaf becomes fp32.

The tree is plain nested dicts of numpy arrays (``jax.device_get`` of a flax
tree), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


_QUANT_LEAVES = {"kernel_q": "weight_q", "scale": "weight_scale", "bias": "bias"}


def _flatten(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    """(path, leaf, in a quantised scope?) for every leaf."""
    quant = "kernel_q" in tree
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, path + (key,))
        else:
            yield path + (key,), val, quant


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax path (without 'params') -> (torch key, transpose?)."""
    *mods, leaf = path
    name = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
    return ".".join([*mods, name]), leaf in ("kernel", "in_proj_weight")


def convert_leaf(path: Tuple[str, ...], leaf, quant: bool = False) -> Tuple[str, np.ndarray]:
    """One flax leaf -> (torch key, array in torch layout; a view where the
    layout allows). ``quant``: the leaf lies in a quantised scope."""
    path = tuple(p for p in path if p != "params")
    if quant:
        *mods, name = path
        if name not in _QUANT_LEAVES:
            raise KeyError(f"unexpected leaf {'.'.join(path)} in a quantised scope")
        dtype = np.int8 if name == "kernel_q" else np.float32
        return ".".join([*mods, _QUANT_LEAVES[name]]), np.asarray(leaf, dtype=dtype)
    key, transpose = _torch_key(path)
    v = np.asarray(leaf, dtype=np.float32)
    if transpose:
        if v.ndim == 4:  # HWIO -> OIHW
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:
            v = v.T
    return key, v


def flax_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays (a flax variable tree, or a dict of such trees
    keyed by submodule name) -> {torch key: tensor} (fp32; int8 ``weight_q``
    in quantised scopes)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf, quant in _flatten(tree):
        key, v = convert_leaf(path, leaf, quant)
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out
