"""JAX (flax) parameter tree -> this package's torch ``state_dict``.

The flax module names of the JAX package equal the DiffBIR torch checkpoint
key fragments, so a flax leaf path joined with '.' is the torch key; only
the leaf name and the layout change, by the rules of
``diffbir_tpu/weights/convert.py::flax_to_torch_state_dict``:

- ``kernel`` -> ``weight``: conv HWIO -> OIHW, dense (I, O) -> (O, I)
- ``scale`` / ``embedding`` -> ``weight``
- ``in_proj_weight`` (d, 3d) -> (3d, d)
- ``params`` collection keys are dropped.

A 4-D kernel is either a conv's HWIO or a transposed conv's: flax's
``ConvTranspose(transpose_kernel=True)`` (every site of the repository:
SCUNet's up-convolutions) stores (kh, kw, out, in), and the same
HWIO -> OIHW permutation gives torch's ``ConvTranspose2d`` weight (in, out,
kh, kw). Given the module's shapes (``flax_to_state_dict(tree, shapes=)``),
a kernel that does not fit that way is read as flax's default
``ConvTranspose`` layout (kh, kw, in, out) of the spatially flipped kernel,
and refused where in == out, since there the two layouts share a shape: the
inverse of the JAX ``_convert_value``.

A quantised scope (the JAX int8 serving layout: a dict holding ``kernel_q``)
keeps its tensors in the JAX layout, so the int8 kernels of both packages
read one tensor:

- ``kernel_q`` -> ``weight_q``, int8, unchanged: [K, N] for a dense site
  (``QuantLinear``), HWIO (3, 3, Cin, Cout) or (1, 1, Cin, Cout) for a conv
  (``QuantConv``);
- ``scale`` -> ``weight_scale``, fp32 [N] (one per output channel);
- ``bias`` -> ``bias``.

Every other leaf becomes fp32.

The LLaVA captioner's functional trees (lists of layers, HF key names) go
through ``llava_to_state_dict`` instead; its quantised scopes hold ``w_q`` or
``w_q4``, so a LayerNorm's ``scale`` is never taken for a quantised one.

The face networks' trees (``RetinaFace``, ``ParseNet``: frozen BatchNorm
``scale``/``bias``/``running_mean``/``running_var``) convert by the same
rules; their facexlib torch files load with ``load_facexlib``.

The tree is plain nested dicts of numpy arrays (``jax.device_get`` of a flax
tree), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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


def convert_leaf(path: Tuple[str, ...], leaf, quant: bool = False,
                 shape: Optional[Tuple[int, ...]] = None) -> Tuple[str, np.ndarray]:
    """One flax leaf -> (torch key, array in torch layout; a view where the
    layout allows). ``quant``: the leaf lies in a quantised scope.
    ``shape``: the torch tensor's shape, where known: a 4-D kernel that does
    not fit it by the HWIO rule is taken for a default-layout ConvTranspose
    kernel (see the module's notes), and any other misfit raises."""
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
        if v.ndim == 4:  # HWIO -> OIHW; (kh, kw, out, in) -> (in, out, kh, kw)
            orig, v = v, v.transpose(3, 2, 0, 1)
            if shape is not None and tuple(v.shape) != tuple(shape):
                if orig.shape[2] == orig.shape[3]:
                    raise ValueError(f"{key}: ambiguous ConvTranspose layout (in_ch == "
                                     "out_ch): use transpose_kernel=True in the flax module")
                v = orig[::-1, ::-1].transpose(2, 3, 0, 1)
        elif v.ndim == 2:
            v = v.T
    if shape is not None and tuple(v.shape) != tuple(shape):
        raise ValueError(f"{key}: shape {tuple(v.shape)}, the module {tuple(shape)}")
    return key, v


def flax_to_state_dict(tree: Mapping[str, Any],
                       shapes: Optional[Mapping[str, Tuple[int, ...]]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays (a flax variable tree, or a dict of such trees
    keyed by submodule name) -> {torch key: tensor} (fp32; int8 ``weight_q``
    in quantised scopes). ``shapes``: the target module's {key: shape}, to
    check every float leaf and to place the kernels of transposed convs
    (see the module's notes)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf, quant in _flatten(tree):
        shape = None
        if shapes is not None and not quant:
            shape = shapes.get(_torch_key(tuple(p for p in path if p != "params"))[0])
        key, v = convert_leaf(path, leaf, quant, shape)
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


# --------------------------------------------------------------------------- #
# LLaVA: the JAX package's functional trees (``models/llava.py``)
# --------------------------------------------------------------------------- #
# quantised linears: int8 {w_q [K, N], scale [N]}, packed int4 {w_q4 [K/2, N],
# scale_g [K/128, N]}; both stay in the JAX layout
_LLAVA_QUANT_LEAVES = {"w_q": ("weight_q", np.int8), "scale": ("weight_scale", np.float32),
                       "w_q4": ("weight_q4", np.int8),
                       "scale_g": ("weight_scale_g", np.float32),
                       "bias": ("bias", np.float32)}


def _walk(tree, path: Tuple[str, ...] = ()):
    """(path, leaf, in a quantised linear?) for every leaf; list items are
    path components '0', '1', ..."""
    quant = "w_q" in tree or "w_q4" in tree
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, path + (key,))
        elif isinstance(val, (list, tuple)):
            for i, item in enumerate(val):
                yield from _walk(item, path + (key, str(i)))
        else:
            yield path + (key,), val, quant


def llava_to_state_dict(llama: Mapping[str, Any], vision: Mapping[str, Any],
                        projector: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The three JAX LLaVA trees (``init_llama_params`` or
    ``load_llava_params`` form, float, int8 or int4) -> the state dict of
    ``models.llava.Llava`` (the HF ``llava-hf/llava-1.5-7b-hf`` keys):

    - llama -> ``language_model.model.*``, its ``lm_head`` ->
      ``language_model.lm_head``; vision -> ``vision_tower.vision_model.*``,
      its ``layers`` -> ``encoder.layers``; projector ->
      ``multi_modal_projector.*``; list items -> ``.{i}.``;
    - ``kernel`` -> ``weight``: dense (I, O) -> (O, I), the patch conv HWIO ->
      OIHW; LayerNorm ``scale`` -> ``weight``; ``class_embedding`` and the
      embeddings' and RMSNorms' ``weight`` as they are;
    - quantised linears in the JAX layout: ``w_q`` -> ``weight_q`` (int8),
      ``scale`` -> ``weight_scale``, ``w_q4`` -> ``weight_q4`` (int8),
      ``scale_g`` -> ``weight_scale_g``.

    Every float leaf becomes fp32."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, tree in (("language_model.model", llama), ("vision_tower.vision_model", vision),
                         ("multi_modal_projector", projector)):
        for path, leaf, quant in _walk(tree):
            *mods, name = path
            base = prefix
            if prefix == "language_model.model" and mods[0] == "lm_head":
                base = "language_model"
            elif prefix == "vision_tower.vision_model" and mods and mods[0] == "layers":
                mods[0] = "encoder.layers"
            if quant:
                if name not in _LLAVA_QUANT_LEAVES:
                    raise KeyError(f"unexpected leaf {'.'.join(path)} in a quantised linear")
                name, dtype = _LLAVA_QUANT_LEAVES[name]
                v = np.asarray(leaf, dtype=dtype)
            else:
                v = np.asarray(leaf, dtype=np.float32)
                if name == "kernel":
                    v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
                    name = "weight"
                elif name == "scale":
                    name = "weight"
            key = ".".join([base, *mods, name])
            out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


# --------------------------------------------------------------------------- #
# DiffBIR torch checkpoints (.pth / .ckpt / .pt): the keys already match
# --------------------------------------------------------------------------- #
# where each part of ControlLDM sits in a full Stable Diffusion checkpoint
SD_MODULE_MAP = {
    "unet": "model.diffusion_model.",
    "vae": "first_stage_model.",
    # FrozenOpenCLIPEmbedder wraps open_clip.CLIP as ``self.model``
    "clip": "cond_stage_model.model.",
}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth/.ckpt/.pt`` checkpoint's tensors on the CPU, ``state_dict``
    nesting unwrapped and ``module.`` prefixes stripped (the JAX
    ``load_torch_state_dict``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in obj:
        obj = obj["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


@torch.no_grad()
def load_into(module: torch.nn.Module, sd: Mapping[str, torch.Tensor], prefix: str = "",
              path: str = "the checkpoint") -> torch.nn.Module:
    """Copy ``sd[prefix + key]`` into every entry of the module's state dict,
    cast to its dtype: strict in the JAX ``fill_flax_params`` sense (a key
    of the module missing from the file, or a shape that differs, raises,
    naming the file); keys of the file outside the module are not read."""
    for key, dst in module.state_dict().items():
        src = sd.get(prefix + key)
        if src is None:
            raise KeyError(f"{path}: no tensor {prefix + key!r}")
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: {prefix + key} has shape {tuple(src.shape)}, "
                             f"the model {tuple(dst.shape)}")
        dst.copy_(src)
    return module


@torch.no_grad()
def load_partial(module: torch.nn.Module, sd: Mapping[str, torch.Tensor],
                 path: str = "the checkpoint") -> int:
    """Copy ``sd[key]`` into every entry of the module's state dict, cast to
    its dtype, by the JAX ``fill_flax_params(strict=False)`` rule: an entry
    the file lacks becomes zero (RAM++'s checkpoint loads this way). A shape
    that differs raises, naming the file. Returns the count of entries the
    file lacked."""
    missing = 0
    for key, dst in module.state_dict().items():
        src = sd.get(key)
        if src is None:
            dst.zero_()
            missing += 1
            continue
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: {key} has shape {tuple(src.shape)}, the model "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
    return missing


def load_stable_diffusion(cldm: torch.nn.Module, sd: Mapping[str, torch.Tensor],
                          path: str = "the checkpoint") -> None:
    """The UNet, VAE and CLIP of ``cldm`` from a full SD2.1 checkpoint."""
    for name, prefix in SD_MODULE_MAP.items():
        load_into(getattr(cldm, name), sd, prefix, path)


def load_facexlib(module: torch.nn.Module, path: str) -> torch.nn.Module:
    """A facexlib checkpoint (``detection_Resnet50_Final.pth``,
    ``parsing_parsenet.pth``: ``module.`` prefixes stripped) loaded into the
    port's network with ``load_state_dict(strict=True)``: a missing or an
    extra key raises, naming the file (BatchNorm's ``num_batches_tracked``
    is taken and not read)."""
    try:
        module.load_state_dict(load_torch_state_dict(path), strict=True)
    except RuntimeError as e:
        raise RuntimeError(f"{path}: {e}") from e
    return module.eval()
