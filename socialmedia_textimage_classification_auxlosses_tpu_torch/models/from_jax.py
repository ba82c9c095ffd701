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
* ``layer_{i}``                    -> ``layers.{i}``; LXMERT's
  ``lang_layer_{i}`` / ``vis_layer_{i}`` / ``x_layer_{i}`` -> ``lang_layers.{i}``
  / ``vis_layers.{i}`` / ``x_layers.{i}``
* the text-only ``TextClassifier``'s ``tower`` / ``classifier`` keep their
  names (``models/text.py`` names its modules so)
* the ``scan_layers`` layout ``layers/layer/...`` (LXMERT's
  ``lang_layers/layer``, ``vis_layers/layer``, ``x_layers/layer``), whose
  leaves carry a leading layer axis, -> ``layers.{i}.…`` one slice per
  layer; slices past the module's own layer count are the JAX package's
  identity pad slots (``models/lxmert.py::pad_layers``, zeros) and are
  dropped when the module is known (``load_jax_params``);
* flax's ``batch_stats`` collection (a ResNet's BatchNorm ``mean`` /
  ``var``), beside ``params`` -> the BatchNorm buffers ``running_mean`` /
  ``running_var`` (``models/resnet.py::BatchNorm``).

Any parameter of the module that the tree lacks, any leaf of the tree that
the module lacks, and any shape that differs raise ``ValueError``. The
tree's leaves may be numpy arrays or CPU torch tensors (bfloat16 ones are
widened to float32, which is exact).

The JAX Faster R-CNN's tree ``{"stage1": {"params": {"backbone", "rpn_head"}},
"stage2": {"params": {"res5_head", "box_predictor"}}}`` has names of its own,
and ``frcnn_state_from_jax`` maps it to the published Detectron2 layout the
port's detector carries (``models/frcnn.py``): ``stem_conv1`` / ``stem_norm1``
-> ``backbone.stem.conv1`` / ``.conv1.norm``, ``res{s}_{b}`` ->
``backbone.res{s}.{b}`` (``conv{i}`` and ``norm{i}`` -> ``conv{i}`` and
``conv{i}.norm``, ``shortcut_norm`` -> ``shortcut.norm``), ``rpn_head`` ->
``proposal_generator.rpn_head``, ``res5_head/res5_{b}`` -> ``roi_heads.res5.{b}``,
``box_predictor`` -> ``roi_heads.box_predictor``; kernels change layout as
above and frozen batch norm's four leaves keep their names.

``jax_tree_from_torch`` is the inverse: a module's parameters (and BatchNorm
buffers) as the JAX package's tree ``{"params": {...}}`` (``{"params",
"batch_stats"}`` for a model with BatchNorm), unrolled or in the ``scan_layers``
layout (JAX ``hf_import.py::stack_scan_layers`` and
``stack_lxmert_scan_layers`` without pad slots), with torch tensors as
leaves, for ``train/flax_msgpack.py`` to write where flax is absent.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .resnet import BatchNorm

_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
# a layer of a stack: ``layer_{i}`` (module list ``layers``), and LXMERT's
# ``lang_layer_{i}`` / ``vis_layer_{i}`` / ``x_layer_{i}``
_LAYER = re.compile(r"((?:lang|vis|x)_)?layer_(\d+)$")
_STACK = re.compile(r"(?:(?:lang|vis|x)_)?layers$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, _as_numpy(value)


def _as_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def _convert_leaf(name: str, array: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if array.ndim == 2:  # Dense (in, out) -> Linear (out, in)
            array = array.T
        elif array.ndim == 4:  # Conv HWIO -> OIHW
            array = array.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {array.ndim} has no torch layout here")
    return _LEAF_NAMES.get(name, name), array


def torch_state_from_jax(tree: Mapping, layer_counts: Optional[Mapping[str, int]] = None
                         ) -> Dict[str, np.ndarray]:
    """The JAX tree as a flat ``{state_dict key: array}`` in torch layouts:
    ``{"params"}``, ``{"params", "batch_stats"}`` or a bare parameter
    tree. ``layer_counts`` (a module list's dotted name -> its length)
    drops a scanned stack's slices past that length (pad slots)."""
    counts = layer_counts or {}
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        out = _state_of(tree["params"], _convert_leaf, counts)
        out.update(_state_of(tree.get("batch_stats", {}),
                             lambda leaf, array: (_STAT_NAMES[leaf], array), counts))
        return out
    return _state_of(tree, _convert_leaf, counts)


def _state_of(tree: Mapping, convert, counts: Mapping[str, int]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for path, array in _flatten(tree):
        *mods, leaf = path
        for i in range(len(mods) - 1):
            if _STACK.match(mods[i]) and mods[i + 1] == "layer":  # scan layout
                head, tail = mods[:i + 1], mods[i + 2:]
                n = counts.get(".".join(head), len(array))
                for layer, sliced in enumerate(array[:n]):
                    name, conv = convert(leaf, np.asarray(sliced))
                    out[".".join(head + [str(layer)] + tail + [name])] = conv
                break
        else:
            mods = [f"{m.group(1) or ''}layers.{m.group(2)}" if (m := _LAYER.match(s)) else s
                    for s in mods]
            name, conv = convert(leaf, array)
            out[".".join(mods + [name])] = conv
    return out


def layer_counts(module: nn.Module) -> Dict[str, int]:
    """Every module list's dotted name and length (the layer stacks)."""
    return {name: len(m) for name, m in module.named_modules() if isinstance(m, nn.ModuleList)}


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX parameter tree into ``module`` (in place; returns it).
    Each value is cast to the dtype of the parameter it lands in."""
    state = torch_state_from_jax(tree, layer_counts(module))
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


def _jax_leaf(module: nn.Module, name: str, value: torch.Tensor) -> Tuple[str, torch.Tensor]:
    """A parameter's flax leaf name and layout, from its module's type."""
    if name != "weight":
        return name, value
    if isinstance(module, nn.Linear):
        return "kernel", value.t().contiguous()
    if isinstance(module, nn.Conv2d):
        return "kernel", value.permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
    if isinstance(module, nn.Embedding):
        return "embedding", value
    if isinstance(module, (nn.LayerNorm, BatchNorm)):
        return "scale", value
    raise ValueError(f"a weight of {type(module).__name__} has no flax name here")


def _stack_layers(node: Dict) -> Dict:
    """Every ``layer_{i}`` run of a subtree as ``layers/layer`` (LXMERT's
    ``lang_layer_{i}`` run as ``lang_layers/layer``, ...) with a leading
    layer axis (the ``lax.scan`` layout)."""
    if not isinstance(node, dict):
        return node
    node = {k: _stack_layers(v) for k, v in node.items()}
    runs: Dict[str, list] = {}
    for k in node:
        if m := _LAYER.match(k):
            runs.setdefault(m.group(1) or "", []).append((int(m.group(2)), k))
    if not runs:
        return node

    def stack(*subtrees):
        if isinstance(subtrees[0], dict):
            return {k: stack(*(t[k] for t in subtrees)) for k in subtrees[0]}
        return torch.stack(subtrees)

    out = {k: v for k, v in node.items() if not _LAYER.match(k)}
    for prefix, found in runs.items():
        found.sort()
        if [i for i, _ in found] != list(range(len(found))):
            raise ValueError(f"layers {[k for _, k in found]} are not numbered 0..n-1")
        out[f"{prefix}layers"] = {"layer": stack(*(node[k] for _, k in found))}
    return out


def _flax_path(mod_name: str) -> list:
    """A module's dotted name as the JAX tree's path: ``layers.3`` ->
    ``layer_3``, LXMERT's ``x_layers.3`` -> ``x_layer_3``."""
    segments = mod_name.split(".") if mod_name else []
    path, i = [], 0
    while i < len(segments):
        if _STACK.match(segments[i]) and i + 1 < len(segments) and segments[i + 1].isdigit():
            path.append(f"{segments[i][:-1]}_{segments[i + 1]}")
            i += 2
        else:
            path.append(segments[i])
            i += 1
    return path


def dense_kernels(module: nn.Module, scan_layers: bool = False) -> Dict[str, int]:
    """The parameters that ``jax_tree_from_torch(module, scan_layers)`` writes
    as flax Dense ``kernel`` leaves (the ``nn.Linear`` weights), each with
    the rank of that leaf: 2, or 3 for a layer of a stack in the
    ``scan_layers`` layout (``_stack_layers`` stacks every ``layer_{i}``
    run, at any depth). Keys are state-dict names."""
    out = {}
    for mod_name, mod in module.named_modules():
        if isinstance(mod, nn.Linear):
            stacked = scan_layers and any(_LAYER.match(s) for s in _flax_path(mod_name))
            out[f"{mod_name}.weight" if mod_name else "weight"] = 3 if stacked else 2
    return out


def jax_tree_from_torch(module: nn.Module, scan_layers: bool = False) -> Dict:
    """The inverse of ``torch_state_from_jax``: ``module``'s parameters as
    the JAX tree ``{"params": {...}}`` (Linear (out, in) -> Dense kernel (in,
    out), Conv2d OIHW -> HWIO, Embedding / LayerNorm / BatchNorm weight ->
    ``embedding`` / ``scale``, ``layers.{i}`` -> ``layer_{i}``), detached CPU
    tensors in the parameters' dtypes, and the BatchNorm buffers as
    ``{"batch_stats": {... {"mean", "var"}}}`` beside them; with
    ``scan_layers``, each layer stack stacked as ``layers/layer``. Any other
    buffer in the state dict raises: the tree holds parameters and
    BatchNorm statistics only."""
    stat_leaves = {v: k for k, v in _STAT_NAMES.items()}
    params = dict(module.named_parameters())
    stats = {f"{n}.{b}" for n, m in module.named_modules() if isinstance(m, BatchNorm)
             for b in stat_leaves}
    buffers = [n for n in module.state_dict() if n not in params and n not in stats]
    if buffers:
        raise ValueError(f"{type(module).__name__} has buffers {buffers[:4]}, which a JAX "
                         "parameter tree does not hold")
    tree: Dict = {}
    batch_stats: Dict = {}
    for mod_name, mod in module.named_modules():
        path = _flax_path(mod_name)
        leaves = [(tree, *_jax_leaf(mod, leaf, p.detach().cpu()))
                  for leaf, p in mod.named_parameters(recurse=False)]
        if isinstance(mod, BatchNorm):
            leaves += [(batch_stats, stat_leaves[leaf], b.detach().cpu())
                       for leaf, b in mod.named_buffers(recurse=False)]
        for root, name, value in leaves:
            node = root
            for seg in path:
                node = node.setdefault(seg, {})
            node[name] = value
    out = {"params": _stack_layers(tree) if scan_layers else tree}
    if batch_stats:
        out["batch_stats"] = _stack_layers(batch_stats) if scan_layers else batch_stats
    return out


_FRCNN_BLOCK = re.compile(r"res(\d+)_(\d+)$")


def _frcnn_bottleneck(prefix: str, node: Mapping) -> Dict[str, str]:
    """A Caffe bottleneck's flax module names -> Detectron2 module paths."""
    names = {}
    for key in node:
        if key.startswith("conv") or key == "shortcut":
            names[key] = f"{prefix}.{key}"
        elif key.startswith("norm"):
            names[key] = f"{prefix}.conv{key[4:]}.norm"
        elif key == "shortcut_norm":
            names[key] = f"{prefix}.shortcut.norm"
        else:
            raise ValueError(f"{prefix}: unknown bottleneck module {key!r}")
    return names


def frcnn_state_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """The JAX detector's ``{"stage1", "stage2"}`` parameter tree as a flat
    state dict in the published layout (module docstring), HWIO -> OIHW for
    convs, (in, out) -> (out, in) for Dense, the frozen batch norms' four
    leaves as they are."""
    s1, s2 = tree["stage1"]["params"], tree["stage2"]["params"]
    modules: Dict[str, Mapping] = {}
    for key, node in s1["backbone"].items():
        if key == "stem_conv1":
            modules["backbone.stem.conv1"] = node
        elif key == "stem_norm1":
            modules["backbone.stem.conv1.norm"] = node
        elif m := _FRCNN_BLOCK.match(key):
            prefix = f"backbone.res{m.group(1)}.{m.group(2)}"
            modules.update({path: node[k] for k, path in _frcnn_bottleneck(prefix, node).items()})
        else:
            raise ValueError(f"unknown backbone module {key!r}")
    for key, node in s1["rpn_head"].items():
        modules[f"proposal_generator.rpn_head.{key}"] = node
    for key, node in s2["res5_head"].items():
        m = _FRCNN_BLOCK.match(key)
        if m is None or m.group(1) != "5":
            raise ValueError(f"unknown res5 module {key!r}")
        prefix = f"roi_heads.res5.{m.group(2)}"
        modules.update({path: node[k] for k, path in _frcnn_bottleneck(prefix, node).items()})
    for key, node in s2["box_predictor"].items():
        modules[f"roi_heads.box_predictor.{key}"] = node
    out = {}
    for path, node in modules.items():
        for leaf, value in node.items():
            name, array = _convert_leaf(leaf, _as_numpy(value))
            out[f"{path}.{name}"] = array
    return out


def frcnn_flax_path(mod_name: str) -> list:
    """A detector stage's convolution or dense layer, named in the published
    layout, as its path in the JAX stage's ``params`` tree (the inverse of
    ``frcnn_state_from_jax``'s names): ``backbone.stem.conv1`` ->
    ``backbone/stem_conv1``, ``backbone.res{s}.{b}.x`` ->
    ``backbone/res{s}_{b}/x``, ``proposal_generator.rpn_head.x`` ->
    ``rpn_head/x``, ``roi_heads.res5.{b}.x`` -> ``res5_head/res5_{b}/x``,
    ``roi_heads.box_predictor.x`` -> ``box_predictor/x``."""
    parts = mod_name.split(".")
    if parts == ["backbone", "stem", "conv1"]:
        return ["backbone", "stem_conv1"]
    if parts[:2] in (["proposal_generator", "rpn_head"], ["roi_heads", "box_predictor"]):
        return parts[1:]
    if parts[0] == "backbone" and len(parts) > 3:
        return ["backbone", f"{parts[1]}_{parts[2]}", *parts[3:]]
    if parts[:2] == ["roi_heads", "res5"] and len(parts) > 3:
        return ["res5_head", f"res5_{parts[2]}", *parts[3:]]
    raise ValueError(f"{mod_name!r} is not a layer of the detector's layout")


def load_jax_frcnn(detector, tree: Mapping):
    """Copy the JAX detector's tree into the port's ``FrcnnDetector``
    (strictly; returns it)."""
    detector.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                              for k, v in frcnn_state_from_jax(tree).items()})
    return detector
