"""Builds the late-fusion model for serving.

Counterpart of ``build_mm_late_setup`` in the JAX package's ``cli/_build.py``,
serving part only: the model for the transformer towers, the tokenizer and
the forward. It builds no data splits, pipelines, optimizer or mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core import config as C
from ..data.images import normalize_on_device
from ..data.tokenizers import TweetTokenizerFrontend, build_tokenizer
from ..models.encoder import init_weights
from ..models.fusion import FUSION_NAMES, MMLateModel
from ..models.text import NO_TOKEN_TYPES, text_encoder_config
from ..models.vision import CNN_MODELS, IMAGE_NORM, vision_encoder_config, vit_geometry
from ._common import arch_overrides


@dataclasses.dataclass
class Setup:
    model: MMLateModel
    tokenizer: TweetTokenizerFrontend
    image_size: int
    image_norm: tuple
    # batch of device tensors (ids, mask, [token_type_ids], pixel_values as
    # uint8 NHWC) -> the model's output dict
    forward_fn: Callable


def check_mm_late_supported(args) -> None:
    """Raise ``SystemExit`` for a tower or fusion head this port lacks."""
    if args.img_model_name in CNN_MODELS or args.fusion_name in ("xatt", "concat_cnn"):
        raise SystemExit(
            f"--img_model_name {args.img_model_name} / --fusion_name "
            f"{args.fusion_name}: the CNN fusion path (MMCnnModel) is not "
            "ported to PyTorch yet")
    if args.img_model_name == "beit":
        raise SystemExit("--img_model_name beit: the BEiT tower is not ported "
                         "to PyTorch yet")
    if args.fusion_name not in FUSION_NAMES:
        raise SystemExit(f"--fusion_name {args.fusion_name}: unknown")


def build_mm_late_setup(args, cfg: C.ServingConfig,
                        generator: Optional[torch.Generator] = None) -> Setup:
    """The late-fusion model on the CPU in float32: random init from
    ``generator`` when one is given, else uninitialised storage for a
    checkpoint to fill."""
    check_mm_late_supported(args)
    txt_name, img_name = args.txt_model_name, args.img_model_name
    txt_dir = C.MODEL_DIR_DICT.get(txt_name)
    img_dir = C.MODEL_DIR_DICT.get(img_name)
    overrides = arch_overrides(args)
    text_cfg = text_encoder_config(txt_name, txt_dir, dtype=args.dtype,
                                   attn_impl=args.attn_impl, **overrides)
    vis_cfg = vision_encoder_config(img_name, img_dir, dtype=args.dtype,
                                    attn_impl=args.attn_impl, **overrides)
    geo = vit_geometry(img_name, img_dir)
    tokenizer = build_tokenizer(txt_name, txt_dir, cfg.max_length, text_cfg.vocab_size)
    with torch.device("meta"):  # no default init: it is replaced anyway
        model = MMLateModel(text_cfg, vis_cfg, cfg.num_labels,
                            fusion_name=args.fusion_name, dropout=cfg.dropout,
                            patch=geo["patch"], image_size=geo["image_size"],
                            num_prefix_tokens=geo["num_prefix_tokens"],
                            vision_pooling=geo["pooling"])
    model = model.to_empty(device="cpu").eval()
    if generator is not None:
        init_weights(model, generator)
        with torch.no_grad():
            model.dual.logit_scale.fill_(2.6592)  # DualEncoder's init value

    mean, std = IMAGE_NORM[img_name]
    dtype = getattr(torch, args.dtype)
    use_tt = txt_name not in NO_TOKEN_TYPES

    def forward_fn(batch):
        pixels = normalize_on_device(batch["pixel_values"], mean, std, dtype)
        return model(batch["ids"], batch["mask"], pixels,
                     batch.get("token_type_ids") if use_tt else None,
                     iadds_task=cfg.use_iadds_loss)

    return Setup(model=model, tokenizer=tokenizer, image_size=geo["image_size"],
                 image_norm=(mean, std), forward_fn=forward_fn)
