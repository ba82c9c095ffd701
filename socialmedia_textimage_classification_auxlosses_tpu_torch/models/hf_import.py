"""Pretrained-checkpoint import into the port's modules.

Counterpart of the JAX package's ``models/hf_import.py`` for the towers the
port has: a Hugging Face checkpoint directory (BERT / RoBERTa / Bernice, ViT /
DeiT, BEiT, ViLT, LXMERT; MMBT's BERT with its word table moved to the
backbone), a torchvision ResNet state dict (``.pth`` or ``.npz``; its
BatchNorm running statistics land in the port's buffers, flax's
``batch_stats``) or a reference-trained ``MM_Model`` / ``ViLT`` / ``Lxmert``
state dict is read
into numpy, mapped tensor by tensor onto the flax-layout tree the JAX package
builds (the same functions, copied here), and that tree goes through
``models/from_jax.py::torch_state_from_jax`` (dense kernels transposed back,
conv kernels HWIO -> OIHW) into the module's own parameters.
``merge_into`` takes the place of the JAX ``merge_tower``: every key must name
a parameter of the module and every shape must match, and the values are
cast to float32 before they are copied in.

Reading needs no package beyond torch and numpy: ``pytorch_model.bin`` /
``.pt`` load with ``torch.load(..., weights_only=True)``, and
``model.safetensors`` is read by ``read_safetensors`` (an 8-byte
little-endian header length, the JSON header, then the raw tensors), and
``flax_model.msgpack`` by the port's own msgpack reader
(``train/flax_msgpack.py``), its tree flattened to dotted keys as the JAX
``load_state_dict`` does. With no checkpoint in the directory the module
keeps its random weights, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .from_jax import torch_state_from_jax

CHECKPOINT_FILES = ("model.safetensors", "pytorch_model.bin", "pytorch_model.pt")

# safetensors dtype names -> numpy; BF16 is widened to float32 by hand
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as ``{name: array}``: the header's length as
    a little-endian uint64, the JSON header (``dtype``, ``shape``,
    ``data_offsets`` per tensor), then the tensors' raw little-endian bytes.
    BF16 tensors come back as float32 (exact)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = data[start:end]
        kind = info["dtype"]
        if kind == "BF16":
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif kind in _ST_DTYPES:
            arr = np.frombuffer(raw, np.dtype(_ST_DTYPES[kind]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {kind}, which the "
                             "safetensors reader does not take")
        out[name] = arr.reshape(info["shape"])
    return out


def _numpy_state(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in sd.items()}


def load_state_dict(model_dir: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """The checkpoint in ``model_dir`` as numpy arrays, or None when the
    directory holds none."""
    if not model_dir or not os.path.isdir(model_dir):
        return None
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.isfile(st_path):
        return read_safetensors(st_path)
    for name in ("pytorch_model.bin", "pytorch_model.pt"):
        path = os.path.join(model_dir, name)
        if os.path.isfile(path):
            return _numpy_state(torch.load(path, map_location="cpu", weights_only=True))
    flax_path = os.path.join(model_dir, "flax_model.msgpack")
    if os.path.isfile(flax_path):
        from ..train.flax_msgpack import read_file
        from .from_jax import _flatten

        # dotted keys, bfloat16 widened to float32, as the JAX package's _flatten
        return {".".join(path): v for path, v in _flatten(read_file(flax_path))}
    return None


def strip_prefix(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Remove a single leading model-name scope (``bert.``, ``roberta.``,
    ``vit.``, ...) if every key shares it."""
    for prefix in ("bert.", "roberta.", "xlm-roberta.", "vit.", "beit.", "deit.",
                   "vilt.", "lxmert.", "model."):
        if all(k.startswith(prefix) or k.startswith("pooler") or k.startswith("cls")
               for k in state):
            return {k[len(prefix):] if k.startswith(prefix) else k: v
                    for k, v in state.items()}
    return state


def _dense(state, key):
    return {"kernel": state[f"{key}.weight"].T.copy(), "bias": state[f"{key}.bias"].copy()}


def _dense_nobias(state, key):
    return {"kernel": state[f"{key}.weight"].T.copy()}


def _ln(state, key):
    return {"scale": state[f"{key}.weight"].copy(), "bias": state[f"{key}.bias"].copy()}


def _emb(state, key):
    return {"embedding": state[f"{key}.weight"].copy()}


def _mlp(state, p):
    return {"mlp_in": _dense(state, f"{p}.intermediate.dense"),
            "mlp_out": _dense(state, f"{p}.output.dense")}


def _attention(state, p, inner):
    """q, k, v under ``{p}.{inner}`` and the output projection under
    ``{p}.output.dense`` (BERT: inner ``self``; ViT: ``attention``)."""
    return {"query": _dense(state, f"{p}.{inner}.query"),
            "key": _dense(state, f"{p}.{inner}.key"),
            "value": _dense(state, f"{p}.{inner}.value"),
            "out": _dense(state, f"{p}.output.dense")}


def _bert_layer(state, p):
    """A BERT-named transformer block -> the EncoderLayer subtree."""
    return {
        "attention": _attention(state, f"{p}.attention", "self"),
        "ln_attn": _ln(state, f"{p}.attention.output.LayerNorm"),
        "mlp": _mlp(state, p),
        "ln_mlp": _ln(state, f"{p}.output.LayerNorm"),
    }


def import_bert_tower(state: Dict[str, np.ndarray], num_layers: int) -> dict:
    """HF BertModel/RobertaModel/XLM-R state dict -> the BertEncoder tree."""
    state = strip_prefix(state)
    tree: dict = {
        "embeddings": {
            "word": _emb(state, "embeddings.word_embeddings"),
            "position": _emb(state, "embeddings.position_embeddings"),
            "ln": _ln(state, "embeddings.LayerNorm"),
        },
        "encoder": {},
        "pooler": {"dense": _dense(state, "pooler.dense")},
    }
    if "embeddings.token_type_embeddings.weight" in state:
        tree["embeddings"]["token_type"] = _emb(state, "embeddings.token_type_embeddings")
    for i in range(num_layers):
        tree["encoder"][f"layer_{i}"] = _bert_layer(state, f"encoder.layer.{i}")
    return tree


def import_vit_tower(state: Dict[str, np.ndarray], num_layers: int,
                     distilled: bool = False, pooling: str = "tanh") -> dict:
    """HF ViTModel/DeiTModel state dict -> the ViTEncoder tree (DeiT:
    ``distilled``, the distillation token after CLS)."""
    state = strip_prefix(state)
    prefix_parts = [state["embeddings.cls_token"]]
    if distilled and "embeddings.distillation_token" in state:
        prefix_parts.append(state["embeddings.distillation_token"])
    proj_w = state["embeddings.patch_embeddings.projection.weight"]
    tree: dict = {
        "embeddings": {
            "prefix_tokens": np.concatenate(prefix_parts, axis=1),
            "pos_embed": state["embeddings.position_embeddings"].copy(),
            "proj": {
                "kernel": np.transpose(proj_w, (2, 3, 1, 0)).copy(),  # OIHW -> HWIO
                "bias": state["embeddings.patch_embeddings.projection.bias"].copy(),
            },
        },
        "encoder": {},
        "ln_final": _ln(state, "layernorm"),
    }
    if pooling == "tanh" and "pooler.dense.weight" in state:
        tree["pooler"] = {"dense": _dense(state, "pooler.dense")}
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        tree["encoder"][f"layer_{i}"] = {
            "attention": _attention(state, f"{p}.attention", "attention"),
            "ln_attn": _ln(state, f"{p}.layernorm_before"),
            "mlp": _mlp(state, p),
            "ln_mlp": _ln(state, f"{p}.layernorm_after"),
        }
    return tree


def import_beit_tower(state: Dict[str, np.ndarray], num_layers: int) -> dict:
    """HF BeitModel state dict -> the BeitEncoder tree (per-layer relative
    position table, layer-scale lambdas, no key bias, the mean-pool
    LayerNorm pooler)."""
    state = strip_prefix(state)
    proj_w = state["embeddings.patch_embeddings.projection.weight"]
    tree: dict = {
        "cls_token": state["embeddings.cls_token"].copy(),
        "proj": {
            "kernel": np.transpose(proj_w, (2, 3, 1, 0)).copy(),
            "bias": state["embeddings.patch_embeddings.projection.bias"].copy(),
        },
        "pool_ln": _ln(state, "pooler.layernorm"),
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        att = f"{p}.attention.attention"
        tree[f"layer_{i}"] = {
            "lambda_1": state[f"{p}.lambda_1"].copy(),
            "lambda_2": state[f"{p}.lambda_2"].copy(),
            "attention": {
                "query": _dense(state, f"{att}.query"),
                "key": _dense_nobias(state, f"{att}.key"),
                "value": _dense(state, f"{att}.value"),
                "out": _dense(state, f"{p}.attention.output.dense"),
                "rel_pos_table": state[
                    f"{att}.relative_position_bias.relative_position_bias_table"].copy(),
            },
            "ln_attn": _ln(state, f"{p}.layernorm_before"),
            "mlp": _mlp(state, p),
            "ln_mlp": _ln(state, f"{p}.layernorm_after"),
        }
    return tree


def _conv(state, key):
    return {"kernel": np.transpose(state[f"{key}.weight"], (2, 3, 1, 0)).copy()}


def _bn(state, key):
    return ({"scale": state[f"{key}.weight"].copy(), "bias": state[f"{key}.bias"].copy()},
            {"mean": state[f"{key}.running_mean"].copy(),
             "var": state[f"{key}.running_var"].copy()})


def import_resnet(state: Dict[str, np.ndarray], stage_sizes) -> dict:
    """torchvision resnet state dict -> the ``{"params", "batch_stats"}``
    trees of ``models/resnet.py::ResNet``; the ``fc`` head is skipped (the
    classifier's head is new, of ``num_labels``)."""
    params: dict = {"stem_conv": _conv(state, "conv1")}
    stats: dict = {}
    params["stem_bn"], stats["stem_bn"] = _bn(state, "bn1")
    for s, blocks in enumerate(stage_sizes):
        for b in range(blocks):
            src, dst = f"layer{s + 1}.{b}", f"stage{s}_block{b}"
            node_p: dict = {}
            node_s: dict = {}
            for c in (1, 2, 3):
                node_p[f"conv{c}"] = _conv(state, f"{src}.conv{c}")
                node_p[f"bn{c}"], node_s[f"bn{c}"] = _bn(state, f"{src}.bn{c}")
            if f"{src}.downsample.0.weight" in state:
                node_p["down_conv"] = _conv(state, f"{src}.downsample.0")
                node_p["down_bn"], node_s["down_bn"] = _bn(state, f"{src}.downsample.1")
            params[dst], stats[dst] = node_p, node_s
    return {"params": params, "batch_stats": stats}


def import_vilt(state: Dict[str, np.ndarray], num_layers: int) -> dict:
    """HF ViltModel state dict -> the ViltBackbone tree."""
    state = strip_prefix(state)
    proj_w = state["embeddings.patch_embeddings.projection.weight"]
    tree: dict = {
        "text_embeddings": {
            "word": _emb(state, "embeddings.text_embeddings.word_embeddings"),
            "position": _emb(state, "embeddings.text_embeddings.position_embeddings"),
            "token_type": _emb(state, "embeddings.text_embeddings.token_type_embeddings"),
            "ln": _ln(state, "embeddings.text_embeddings.LayerNorm"),
        },
        "patch_proj": {
            "kernel": np.transpose(proj_w, (2, 3, 1, 0)).copy(),
            "bias": state["embeddings.patch_embeddings.projection.bias"].copy(),
        },
        "image_cls": state["embeddings.cls_token"].copy(),
        "image_pos": state["embeddings.position_embeddings"].copy(),
        "modality_type": _emb(state, "embeddings.token_type_embeddings"),
        "encoder": {},
        "ln_final": _ln(state, "layernorm"),
        "pooler": {"dense": _dense(state, "pooler.dense")},
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        tree["encoder"][f"layer_{i}"] = {
            "attention": _attention(state, f"{p}.attention", "attention"),
            "ln_attn": _ln(state, f"{p}.layernorm_before"),
            "mlp": _mlp(state, p),
            "ln_mlp": _ln(state, f"{p}.layernorm_after"),
        }
    return tree


def import_lxmert(state: Dict[str, np.ndarray], l_layers: int, r_layers: int,
                  x_layers: int) -> dict:
    """HF LxmertModel state dict -> the LxmertBackbone tree (the x-layers'
    one ``visual_attention`` is the shared cross-attention)."""
    state = strip_prefix(state)
    tree: dict = {
        "embeddings": {
            "word": _emb(state, "embeddings.word_embeddings"),
            "position": _emb(state, "embeddings.position_embeddings"),
            "token_type": _emb(state, "embeddings.token_type_embeddings"),
            "ln": _ln(state, "embeddings.LayerNorm"),
        },
        "visual_embeddings": {
            "feat_proj": _dense(state, "encoder.visn_fc.visn_fc"),
            "feat_ln": _ln(state, "encoder.visn_fc.visn_layer_norm"),
            "pos_proj": _dense(state, "encoder.visn_fc.box_fc"),
            "pos_ln": _ln(state, "encoder.visn_fc.box_layer_norm"),
        },
    }
    for i in range(l_layers):
        tree[f"lang_layer_{i}"] = _bert_layer(state, f"encoder.layer.{i}")
    for i in range(r_layers):
        tree[f"vis_layer_{i}"] = _bert_layer(state, f"encoder.r_layers.{i}")
    for i in range(x_layers):
        p = f"encoder.x_layers.{i}"
        tree[f"x_layer_{i}"] = {
            "cross_attention": _attention(state, f"{p}.visual_attention", "att"),
            "ln_cross": _ln(state, f"{p}.visual_attention.output.LayerNorm"),
            "lang_self": _attention(state, f"{p}.lang_self_att", "self"),
            "ln_self_l": _ln(state, f"{p}.lang_self_att.output.LayerNorm"),
            "vis_self": _attention(state, f"{p}.visn_self_att", "self"),
            "ln_self_v": _ln(state, f"{p}.visn_self_att.output.LayerNorm"),
            "lang_mlp": {"mlp_in": _dense(state, f"{p}.lang_inter.dense"),
                         "mlp_out": _dense(state, f"{p}.lang_output.dense")},
            "ln_mlp_l": _ln(state, f"{p}.lang_output.LayerNorm"),
            "vis_mlp": {"mlp_in": _dense(state, f"{p}.visn_inter.dense"),
                        "mlp_out": _dense(state, f"{p}.visn_output.dense")},
            "ln_mlp_v": _ln(state, f"{p}.visn_output.LayerNorm"),
        }
    return tree


def import_dual_encoder(state: Dict[str, np.ndarray], text_layers: int,
                        vision_layers: int, distilled=False,
                        vision_pooling="tanh") -> dict:
    """HF ``VisionTextDualEncoderModel`` state dict -> the DualEncoder tree
    (text tower + vision tower + projections + logit_scale)."""
    text_state = {k[len("text_model."):]: v for k, v in state.items()
                  if k.startswith("text_model.")}
    vision_state = {k[len("vision_model."):]: v for k, v in state.items()
                    if k.startswith("vision_model.")}
    return {
        "text": import_bert_tower(text_state, text_layers),
        "vision": import_vit_tower(vision_state, vision_layers, distilled, vision_pooling),
        "text_proj": _dense_nobias(state, "text_projection"),
        "visual_proj": _dense_nobias(state, "visual_projection"),
        "logit_scale": np.asarray(state["logit_scale"], np.float32).reshape(()),
    }


def import_reference_mm_late(state: Dict[str, np.ndarray], text_layers: int,
                             vision_layers: int, fusion_name: str = "attention",
                             distilled=False, vision_pooling="tanh") -> dict:
    """A reference-trained ``MM_Model`` state dict -> the MMLateModel tree.

    Reference names: ``dual_encoder.*`` (the HF VisionTextDualEncoderModel),
    the fusion head's ``fc_Q/fc_K/fc_V``, ``linear_fusion``,
    ``aspectattention``, ``linear_gmu_t/v``, and the heads
    ``linear_cls``/``linear_tim``/``linear_iadds``."""
    dual_state = {k[len("dual_encoder."):]: v for k, v in state.items()
                  if k.startswith("dual_encoder.")}
    tree: dict = {
        "dual": import_dual_encoder(dual_state, text_layers, vision_layers,
                                    distilled, vision_pooling),
        "linear_cls": _dense(state, "linear_cls"),
        "linear_tim": _dense(state, "linear_tim"),
        "linear_iadds": _dense(state, "linear_iadds"),
    }
    fusion: dict = {}
    if fusion_name == "attention":
        fusion["fc_q"] = _dense(state, "fc_Q")
        fusion["fc_k"] = _dense(state, "fc_K")
        fusion["fc_v"] = _dense(state, "fc_V")
        fusion["linear_fusion"] = _dense(state, "linear_fusion")
    elif fusion_name == "concat":
        fusion["linear_fusion"] = _dense(state, "linear_fusion")
    elif fusion_name == "aspect-att":
        fusion["aspect_attention"] = _dense(state, "aspectattention")
    elif fusion_name == "gmu":
        fusion["gmu_t"] = _dense(state, "linear_gmu_t")
        fusion["gmu_v"] = _dense(state, "linear_gmu_v")
        fusion["linear_fusion"] = _dense(state, "linear_fusion")
    tree["fusion"] = fusion
    return tree


def import_reference_vilt(state: Dict[str, np.ndarray], num_layers: int) -> dict:
    """A reference-trained ``ViLT`` wrapper state dict (``model.*`` = HF
    ViltModel, plus ``linear``/``linear_tim``/``logit_scale``; its declared
    but unused text/visual projections are skipped) -> the ViltClassifier
    tree."""
    backbone_state = {k[len("model."):]: v for k, v in state.items()
                      if k.startswith("model.")}
    return {
        "backbone": import_vilt(backbone_state, num_layers),
        "linear": _dense(state, "linear"),
        "linear_tim": _dense(state, "linear_tim"),
        "logit_scale": np.asarray(state["logit_scale"], np.float32).reshape(()),
    }


def import_reference_lxmert(state: Dict[str, np.ndarray], l_layers: int, r_layers: int,
                            x_layers: int) -> dict:
    """A reference-trained ``Lxmert`` wrapper state dict (``model.*`` = HF
    LxmertModel, plus ``linear_fusion``/``linear``/``linear_tim``/
    ``logit_scale``) -> the LxmertClassifier tree."""
    backbone_state = {k[len("model."):]: v for k, v in state.items()
                      if k.startswith("model.")}
    return {
        "backbone": import_lxmert(backbone_state, l_layers, r_layers, x_layers),
        "linear_fusion": _dense(state, "linear_fusion"),
        "linear": _dense(state, "linear"),
        "linear_tim": _dense(state, "linear_tim"),
        "logit_scale": np.asarray(state["logit_scale"], np.float32).reshape(()),
    }


def load_torch_file(path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """A state dict saved with ``torch.save`` (or an ``.npz``) as numpy, or
    None when ``path`` is not a file."""
    if not path or not os.path.isfile(path):
        return None
    if path.endswith(".npz"):
        return dict(np.load(path))
    return _numpy_state(torch.load(path, map_location="cpu", weights_only=True))


def merge_into(module: nn.Module, tree: Mapping, prefix: str = "") -> List[str]:
    """Copy an imported tree into ``module``'s parameters below ``prefix``
    (``"dual.text."``; ``""`` for the whole module). Every key must name a
    parameter of the module and every shape must match; nothing is copied
    unless all do. Values are cast to float32, then copied into the
    parameter (on its device, in its dtype). Returns the keys written."""
    state = {prefix + k: v for k, v in torch_state_from_jax(tree).items()}
    own = module.state_dict()
    for key, array in state.items():
        if key not in own:
            raise KeyError(f"unknown parameter {key} in {type(module).__name__}")
        if tuple(own[key].shape) != tuple(np.shape(array)):
            raise ValueError(f"shape mismatch at {key}: {tuple(own[key].shape)} vs "
                             f"{tuple(np.shape(array))}")
    with torch.no_grad():
        for key, array in state.items():
            own[key].copy_(torch.from_numpy(np.array(array, dtype=np.float32)))
    return sorted(state)


def maybe_import_text_tower(module: nn.Module, model_dir: Optional[str], num_layers: int,
                            prefix: str = "dual.text.") -> List[str]:
    """Import the text tower from ``model_dir`` when it holds a checkpoint;
    returns the keys written (none when it holds no checkpoint)."""
    state = load_state_dict(model_dir)
    if state is None:
        return []
    return merge_into(module, import_bert_tower(state, num_layers), prefix)


def maybe_import_vision_tower(module: nn.Module, model_dir: Optional[str], num_layers: int,
                              distilled: bool = False, pooling: str = "tanh",
                              prefix: str = "dual.vision.") -> List[str]:
    """Import the ViT/DeiT tower from ``model_dir`` when it holds a
    checkpoint; returns the keys written."""
    state = load_state_dict(model_dir)
    if state is None:
        return []
    return merge_into(module, import_vit_tower(state, num_layers, distilled, pooling), prefix)


def maybe_import_vilt(module: nn.Module, model_dir: Optional[str], num_layers: int,
                      prefix: str = "backbone.") -> List[str]:
    """Import the ViLT backbone from ``model_dir`` when it holds a
    checkpoint; returns the keys written."""
    state = load_state_dict(model_dir)
    if state is None:
        return []
    return merge_into(module, import_vilt(state, num_layers), prefix)


def maybe_import_beit_tower(module: nn.Module, model_dir: Optional[str], num_layers: int,
                            prefix: str = "dual.vision.") -> List[str]:
    """Import the BEiT tower from ``model_dir`` when it holds a checkpoint;
    returns the keys written."""
    state = load_state_dict(model_dir)
    if state is None:
        return []
    return merge_into(module, import_beit_tower(state, num_layers), prefix)


def maybe_import_resnet(module: nn.Module, weight_path: Optional[str], model_name: str,
                        prefix: str = "") -> List[str]:
    """Import a torchvision ResNet from ``weight_path`` (a ``.pth`` or
    ``.npz`` file, or a checkpoint directory) into the ResNet below
    ``prefix`` (``"cnn."`` in ``MMCnnModel``, ``"trunk."`` under
    ``--conv_att``), its running statistics into the BatchNorm buffers;
    returns the keys written (none when there is no checkpoint)."""
    from .resnet import STAGE_SIZES

    state = load_torch_file(weight_path)
    if state is None and weight_path and os.path.isdir(weight_path):
        state = load_state_dict(weight_path)
    if state is None:
        return []
    return merge_into(module, import_resnet(state, STAGE_SIZES[model_name]), prefix)


def maybe_import_lxmert(module: nn.Module, model_dir: Optional[str], l_layers: int,
                        r_layers: int, x_layers: int, prefix: str = "backbone.") -> List[str]:
    """Import the LXMERT backbone from ``model_dir`` when it holds a
    checkpoint; returns the keys written."""
    state = load_state_dict(model_dir)
    if state is None:
        return []
    return merge_into(module, import_lxmert(state, l_layers, r_layers, x_layers), prefix)


def maybe_import_mmbt(module: nn.Module, model_dir: Optional[str], num_layers: int,
                      cnn_weight_path: Optional[str] = None,
                      cnn_name: str = "resnet152") -> List[str]:
    """MMBT's pretrained parts: BERT's embeddings, encoder and pooler from
    ``model_dir`` (its word table into ``backbone.word``, where the joint
    sequence embeds through it), and a torchvision ResNet from
    ``cnn_weight_path`` into ``backbone.cnn`` when that holds one;
    ``img_proj`` and the heads stay as initialised. Returns the keys
    written."""
    keys: List[str] = []
    state = load_state_dict(model_dir)
    if state is not None:
        tree = import_bert_tower(state, num_layers)
        tree["word"] = tree["embeddings"].pop("word")
        keys += merge_into(module, tree, "backbone.")
    if cnn_weight_path:
        keys += maybe_import_resnet(module, cnn_weight_path, cnn_name, prefix="backbone.cnn.")
    return keys
