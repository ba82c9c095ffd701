"""Carry a JAX parameter tree into the port's modules.

The JAX package's parameters are a nested dict (``{"params": {...}}``) of
arrays; this module takes that tree as nested dicts of numpy arrays (no JAX
or flax needed) and loads it into the port's ``nn.Module`` of the same
architecture. The modules use the flax names, so the map is mechanical:

* Dense ``kernel`` (in, out)      -> Linear ``weight`` (out, in), transposed
* Conv ``kernel`` HWIO             -> Conv2d ``weight`` OIHW
* Embed ``embedding``              -> Embedding ``weight``
* LayerNorm ``scale`` / ``bias``   -> LayerNorm ``weight`` / ``bias``
* ``prefix_tokens``, ``pos_embed``, ViLT's ``image_cls`` and ``image_pos``,
  ``logit_scale`` and biases keep their names
* ``layer_{i}``                    -> ``layers.{i}``
* the ``scan_layers`` layout ``layers/layer/...``, whose leaves carry a
  leading layer axis, -> ``layers.{i}.…`` one slice per layer.

Any parameter of the module that the tree lacks, any leaf of the tree that
the module lacks, and any shape that differs raise ``ValueError``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight"}
_LAYER = re.compile(r"layer_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _convert_leaf(name: str, array: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if array.ndim == 2:  # Dense (in, out) -> Linear (out, in)
            array = array.T
        elif array.ndim == 4:  # Conv HWIO -> OIHW
            array = array.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {array.ndim} has no torch layout here")
    return _LEAF_NAMES.get(name, name), array


def torch_state_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """The JAX tree as a flat ``{state_dict key: array}`` in torch layouts."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}
    for path, array in _flatten(tree):
        *mods, leaf = path
        for i in range(len(mods) - 1):
            if mods[i] == "layers" and mods[i + 1] == "layer":  # scan layout
                head, tail = mods[:i], mods[i + 2:]
                for layer, sliced in enumerate(array):
                    name, conv = _convert_leaf(leaf, np.asarray(sliced))
                    out[".".join(head + ["layers", str(layer)] + tail + [name])] = conv
                break
        else:
            mods = [f"layers.{m.group(1)}" if (m := _LAYER.match(s)) else s for s in mods]
            name, conv = _convert_leaf(leaf, array)
            out[".".join(mods + [name])] = conv
    return out


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX parameter tree into ``module`` (in place; returns it).
    Each value is cast to the dtype of the parameter it lands in."""
    state = torch_state_from_jax(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"JAX tree does not match {type(module).__name__}: "
                         f"missing {missing[:8]}{'...' if len(missing) > 8 else ''}, "
                         f"left over {extra[:8]}{'...' if len(extra) > 8 else ''}")
    for key, array in state.items():
        if tuple(own[key].shape) != array.shape:
            raise ValueError(f"{key}: JAX shape {array.shape} vs torch "
                             f"{tuple(own[key].shape)}")
    with torch.no_grad():
        for key, array in state.items():
            own[key].copy_(torch.tensor(np.asarray(array, np.float32)))
    return module
