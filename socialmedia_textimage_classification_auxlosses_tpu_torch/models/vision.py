"""Image tower configurations and geometry.

Counterpart of the JAX package's ``models/vision.py`` (configuration part).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .encoder import EncoderConfig

VISION_PRESETS = {
    "vit": dict(patch=16, image_size=224, num_prefix_tokens=1, pooling="tanh"),
    "beit": dict(patch=16, image_size=224, num_prefix_tokens=1, pooling="mean"),
    "deit": dict(patch=16, image_size=224, num_prefix_tokens=2, pooling="tanh"),
}

CNN_MODELS = {"resnet50", "resnet152"}

# Per-model pixel normalization (HF feature-extractor semantics).
IMAGE_NORM = {
    "vit": ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    "beit": ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    "deit": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "vilt": ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    "imagenet": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "mm_cnn": ([0.46777044, 0.44531429, 0.40661017],
               [0.12221994, 0.12145835, 0.14380469]),
}


def _load_hf_config(model_dir: Optional[str]) -> dict:
    if model_dir:
        path = os.path.join(model_dir, "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
    return {}


def vision_encoder_config(
    model_name: str,
    model_dir: Optional[str] = None,
    dtype: str = "float32",
    attn_impl: str = "auto",
    **overrides,
) -> EncoderConfig:
    hf = _load_hf_config(model_dir)
    if hf:
        overrides.setdefault("hidden", hf.get("hidden_size", 768))
        overrides.setdefault("layers", hf.get("num_hidden_layers", 12))
        overrides.setdefault("heads", hf.get("num_attention_heads", 12))
        overrides.setdefault("mlp_dim", hf.get("intermediate_size", 3072))
        overrides.setdefault("ln_eps", hf.get("layer_norm_eps", 1e-12))
        overrides.setdefault("dropout", hf.get("hidden_dropout_prob", 0.0))
    overrides.setdefault("ln_eps", 1e-12)
    return EncoderConfig(vocab_size=1, max_positions=1, type_vocab=0,
                         ln_style="pre", dtype=dtype, attn_impl=attn_impl,
                         **overrides)


def vit_geometry(model_name: str, model_dir: Optional[str] = None) -> dict:
    geo = dict(VISION_PRESETS[model_name])
    hf = _load_hf_config(model_dir)
    if hf:
        geo["patch"] = hf.get("patch_size", geo["patch"])
        geo["image_size"] = hf.get("image_size", geo["image_size"])
    return geo
