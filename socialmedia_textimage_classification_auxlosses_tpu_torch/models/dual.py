"""Vision-text dual encoder.

Counterpart of the JAX package's ``models/dual.py``: text tower + vision
tower (ViT/DeiT, or BEiT with ``vision_arch="beit"``), CLIP-style
projections of the pooled outputs and a learnable temperature;
``logits_per_text`` is the scaled cosine similarity.
"""

from __future__ import annotations

import torch
from torch import nn

from .encoder import BertEncoder, EncoderConfig, ViTEncoder, linear, per_seed


class DualEncoder(nn.Module):
    def __init__(self, text_cfg: EncoderConfig, vision_cfg: EncoderConfig,
                 patch: int = 16, image_size: int = 224,
                 num_prefix_tokens: int = 1, vision_pooling: str = "tanh",
                 vision_arch: str = "vit", projection_dim: int = 512,
                 logit_scale_init: float = 2.6592):
        super().__init__()
        self.text = BertEncoder(text_cfg)
        if vision_arch == "beit":
            from .beit import BeitEncoder

            self.vision = BeitEncoder(vision_cfg, patch=patch, image_size=image_size)
        elif vision_arch == "vit":
            self.vision = ViTEncoder(vision_cfg, patch=patch, image_size=image_size,
                                     num_prefix_tokens=num_prefix_tokens,
                                     pooling=vision_pooling)
        else:
            raise ValueError(f"unknown vision_arch {vision_arch!r}")
        self.text_proj = nn.Linear(text_cfg.hidden, projection_dim, bias=False)
        self.visual_proj = nn.Linear(vision_cfg.hidden, projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(logit_scale_init))

    def encode_text(self, ids, attention_mask=None, token_type_ids=None, gen=None):
        return self.text(ids, attention_mask, token_type_ids, gen)

    def encode_vision(self, pixel_values, gen=None):
        return self.vision(pixel_values, gen)

    def logits_per_text(self, text_pooled, vision_pooled):
        """Scaled cosine similarity: rows = texts, cols = images (float32).
        Seed-stacked: each seed's texts against its own images with its own
        scale, the S (B, B) blocks stacked as (S·B, B)."""
        t = linear(self.text_proj, text_pooled.float())
        v = linear(self.visual_proj, vision_pooled.float())
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        scale = torch.exp(self.logit_scale.float())
        if scale.dim() == 0:
            return scale * (t @ v.T)
        s = scale.shape[0]
        sim = torch.bmm(per_seed(t, s), per_seed(v, s).transpose(1, 2))
        return (scale[:, None, None] * sim).reshape(-1, sim.shape[-1])

    def forward(self, ids, attention_mask, pixel_values, token_type_ids=None):
        text_hidden, text_pooled = self.encode_text(ids, attention_mask, token_type_ids)
        vision_hidden, vision_pooled = self.encode_vision(pixel_values)
        return {
            "text_hidden": text_hidden,
            "text_pooled": text_pooled,
            "vision_hidden": vision_hidden,
            "vision_pooled": vision_pooled,
            "logits_per_text": self.logits_per_text(text_pooled, vision_pooled),
        }
