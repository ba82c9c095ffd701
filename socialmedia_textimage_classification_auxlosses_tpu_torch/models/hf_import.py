"""Pretrained-checkpoint import into the port's modules.

Counterpart of the JAX package's ``models/hf_import.py`` for the towers the
port has: a Hugging Face checkpoint directory (BERT / RoBERTa / Bernice, ViT /
DeiT, ViLT) or a reference-trained ``MM_Model`` / ``ViLT`` state dict is read
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
little-endian header length, the JSON header, then the raw tensors). A
directory that holds only ``flax_model.msgpack`` is refused: reading it needs
msgpack (ROADMAP.md Queue 1 item 4). With no checkpoint in the directory the
module keeps its random weights, as in the JAX package.
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
    if os.path.isfile(os.path.join(model_dir, "flax_model.msgpack")):
        raise SystemExit(f"{model_dir!r} holds only flax_model.msgpack: reading it needs "
                         "msgpack, which the PyTorch port does not use (ROADMAP.md Queue 1 "
                         "item 4); convert it to pytorch_model.bin or model.safetensors")
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


def _vit_attention(state, p):
    return {"query": _dense(state, f"{p}.attention.attention.query"),
            "key": _dense(state, f"{p}.attention.attention.key"),
            "value": _dense(state, f"{p}.attention.attention.value"),
            "out": _dense(state, f"{p}.attention.output.dense")}


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
        p = f"encoder.layer.{i}"
        tree["encoder"][f"layer_{i}"] = {
            "attention": {
                "query": _dense(state, f"{p}.attention.self.query"),
                "key": _dense(state, f"{p}.attention.self.key"),
                "value": _dense(state, f"{p}.attention.self.value"),
                "out": _dense(state, f"{p}.attention.output.dense"),
            },
            "ln_attn": _ln(state, f"{p}.attention.output.LayerNorm"),
            "mlp": _mlp(state, p),
            "ln_mlp": _ln(state, f"{p}.output.LayerNorm"),
        }
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
            "attention": _vit_attention(state, p),
            "ln_attn": _ln(state, f"{p}.layernorm_before"),
            "mlp": _mlp(state, p),
            "ln_mlp": _ln(state, f"{p}.layernorm_after"),
        }
    return tree


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
            "attention": _vit_attention(state, p),
            "ln_attn": _ln(state, f"{p}.layernorm_before"),
            "mlp": _mlp(state, p),
            "ln_mlp": _ln(state, f"{p}.layernorm_after"),
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
