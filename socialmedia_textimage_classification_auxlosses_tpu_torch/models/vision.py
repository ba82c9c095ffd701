"""Image towers and their classification heads.

Counterpart of the JAX package's ``models/vision.py``: the tower
configurations, geometry and pixel norms, and the image-only classifiers
of ``cli/run_img.py``:

* ``vit``  - ViT-B/16, the head a linear layer over the final-LN CLS token;
* ``deit`` - distilled ViT (CLS + distillation prefix tokens), the head over
  the tanh CLS pooler;
* ``beit`` - the BEiT tower of ``models/beit.py``, the head over its pooled
  output (LayerNorm of the mean patch token);
* ``resnet50`` / ``resnet152`` - ``models/resnet.py``.

Every head is a float32 linear layer named ``classifier`` (ResNet's ``fc``)
over a tower named ``tower``, as in the flax tree.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from torch import nn

from .encoder import EncoderConfig, ViTEncoder

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


class BeitClassifier(nn.Module):
    """BEiT tower + linear head over the pooled output."""

    def __init__(self, cfg: EncoderConfig, num_labels: int, patch: int = 16,
                 image_size: int = 224):
        super().__init__()
        from .beit import BeitEncoder

        self.cfg = cfg
        self.tower = BeitEncoder(cfg, patch=patch, image_size=image_size)
        self.classifier = nn.Linear(cfg.hidden, num_labels)

    def forward(self, pixel_values, gen=None):
        _, pooled = self.tower(pixel_values, gen)
        return self.classifier(pooled.float())


class VisionClassifier(nn.Module):
    """ViT/DeiT tower + head; ``head_on`` "cls" reads the final-LN CLS token
    (ViT), "pooled" the tanh pooler (DeiT). Returns the logits."""

    def __init__(self, cfg: EncoderConfig, num_labels: int, patch: int = 16,
                 image_size: int = 224, num_prefix_tokens: int = 1,
                 pooling: str = "tanh", head_on: str = "cls"):
        super().__init__()
        self.cfg = cfg
        self.head_on = head_on
        self.tower = ViTEncoder(cfg, patch=patch, image_size=image_size,
                                num_prefix_tokens=num_prefix_tokens, pooling=pooling)
        self.classifier = nn.Linear(cfg.hidden, num_labels)

    def forward(self, pixel_values, gen=None):
        hidden, pooled = self.tower(pixel_values, gen)
        feat = hidden[:, 0, :] if self.head_on == "cls" else pooled
        return self.classifier(feat.float())


def build_vision_classifier(model_name: str, num_labels: int, model_dir: Optional[str] = None,
                            dtype: str = "float32", attn_impl: str = "auto",
                            conv_att: bool = False, **overrides) -> nn.Module:
    """The image-only classifier of ``model_name``; the CNNs through
    ``models/resnet.py::build_resnet_classifier`` (``conv_att``: the
    attention-CNN)."""
    if model_name in CNN_MODELS:
        from .resnet import build_resnet_classifier

        return build_resnet_classifier(model_name, num_labels, dtype=dtype, conv_att=conv_att)
    cfg = vision_encoder_config(model_name, model_dir, dtype=dtype, attn_impl=attn_impl,
                                **overrides)
    geo = vit_geometry(model_name, model_dir)
    if model_name == "beit":
        return BeitClassifier(cfg, num_labels, patch=geo["patch"],
                              image_size=geo["image_size"])
    return VisionClassifier(cfg, num_labels, patch=geo["patch"], image_size=geo["image_size"],
                            num_prefix_tokens=geo["num_prefix_tokens"],
                            pooling=geo["pooling"],
                            head_on="cls" if model_name == "vit" else "pooled")
