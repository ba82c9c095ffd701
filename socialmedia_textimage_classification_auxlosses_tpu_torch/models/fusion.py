"""Late-fusion multimodal classifier, the paper's main model.

Counterpart of the JAX package's ``models/fusion.py``: dual encoder + one of
four fusion heads + the classification and auxiliary heads.

* ``concat``     - CLS_t ++ CLS_v -> linear_fusion -> ReLU
* ``attention``  - the text CLS query attends over the image tokens: one head
                   of full width through ``ops.attention.sdpa`` (the SDPA
                   kernel on a CUDA tensor). It runs in float32, because both
                   towers end in a float32 LayerNorm.
* ``aspect-att`` - tanh-scored softmax over the stacked pooled vectors
* ``gmu``        - sigmoid gate over the CLS tokens blending 2H projections

The head dropout (rate ``dropout``, the CLI's ``--dropout``) acts on the fused
feature before ``linear_cls`` and ``linear_iadds``, not before ``linear_tim``,
as in the JAX module; like the towers' dropout it draws from the forward's
``gen`` and is the identity in eval mode. ``MMCnnModel`` (the ResNet fusion
path) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .dual import DualEncoder
from .encoder import EncoderConfig, dense, dropout

FUSION_NAMES = ("concat", "attention", "aspect-att", "gmu")


class FusionHead(nn.Module):
    """The four fusion variants; emits an H-wide fused feature. Every dense
    layer runs at the dtype of ``text_hidden``, as the flax module does."""

    def __init__(self, hidden: int, fusion_name: str, attn_impl: str = "auto"):
        super().__init__()
        if fusion_name not in FUSION_NAMES:
            raise ValueError(f"unknown fusion {fusion_name}")
        self.hidden = hidden
        self.fusion_name = fusion_name
        self.attn_impl = attn_impl
        h = hidden
        if fusion_name in ("concat", "attention"):
            if fusion_name == "attention":
                self.fc_q = nn.Linear(h, h)
                self.fc_k = nn.Linear(h, h)
                self.fc_v = nn.Linear(h, h)
            self.linear_fusion = nn.Linear(2 * h, h)
        elif fusion_name == "aspect-att":
            self.aspect_attention = nn.Linear(h, 1)
        else:  # gmu
            self.gmu_t = nn.Linear(h, 2 * h)
            self.gmu_v = nn.Linear(h, 2 * h)
            self.linear_fusion = nn.Linear(2 * h, h)

    def forward(self, text_hidden, vision_hidden, text_pooled=None,
                vision_pooled=None):
        dt = text_hidden.dtype
        if self.fusion_name == "concat":
            cat = torch.cat([text_hidden[:, 0, :], vision_hidden[:, 0, :]], -1)
            return F.relu(dense(self.linear_fusion, cat, dt))

        if self.fusion_name == "attention":
            q = dense(self.fc_q, text_hidden[:, :1, :], dt)
            k = dense(self.fc_k, vision_hidden, dt)
            v = dense(self.fc_v, vision_hidden, dt)
            ctx = sdpa(q[:, None], k[:, None], v[:, None],
                       scale=self.hidden ** -0.5, impl=self.attn_impl)[:, 0, 0, :]
            cat = torch.cat([text_hidden[:, 0, :], ctx], -1)
            return F.relu(dense(self.linear_fusion, cat, dt))

        if self.fusion_name == "aspect-att":
            stacked = torch.stack([text_pooled, vision_pooled], dim=1)  # (B, 2, H)
            scores = torch.tanh(dense(self.aspect_attention, stacked, dt))
            weights = torch.softmax(scores.float(), dim=1).to(dt)
            return F.relu(torch.sum(weights * stacked, dim=1))

        cls_t, cls_v = text_hidden[:, 0, :], vision_hidden[:, 0, :]  # gmu
        t_prime = dense(self.gmu_t, cls_t, dt)
        v_prime = dense(self.gmu_v, cls_v, dt)
        z = torch.sigmoid(torch.cat([cls_t, cls_v], -1))
        mixed = z * t_prime + (1.0 - z) * v_prime
        return F.relu(dense(self.linear_fusion, mixed, dt))


class MMLateModel(nn.Module):
    """Dual encoder + fusion + cls/tim/iadds heads.

    ``forward`` returns ``out_cls``, ``logits_per_text``, ``out_tim``,
    ``out_iadds`` and ``mm_features``, as the JAX module does. The TIM rows
    come either from ``tim_ids`` (a second text pass, batched with the first)
    or from ``tim_src`` (rows of the first pass, gathered); the vision
    features are computed once and shared."""

    def __init__(self, text_cfg: EncoderConfig, vision_cfg: EncoderConfig,
                 num_labels: int, fusion_name: str = "concat",
                 dropout: float = 0.05, patch: int = 16, image_size: int = 224,
                 num_prefix_tokens: int = 1, vision_pooling: str = "tanh",
                 vision_arch: str = "vit", projection_dim: int = 512):
        super().__init__()
        self.text_cfg = text_cfg
        self.vision_cfg = vision_cfg
        self.dropout = dropout
        self.dual = DualEncoder(text_cfg, vision_cfg, patch=patch,
                                image_size=image_size,
                                num_prefix_tokens=num_prefix_tokens,
                                vision_pooling=vision_pooling,
                                vision_arch=vision_arch,
                                projection_dim=projection_dim)
        self.fusion = FusionHead(text_cfg.hidden, fusion_name,
                                 attn_impl=text_cfg.attn_impl)
        self.linear_cls = nn.Linear(text_cfg.hidden, num_labels)
        self.linear_tim = nn.Linear(text_cfg.hidden, 2)
        self.linear_iadds = nn.Linear(text_cfg.hidden, 2)

    def encode_vision(self, pixel_values, gen=None):
        return self.dual.encode_vision(pixel_values, gen)

    def forward(self, ids, attention_mask, pixel_values, token_type_ids=None,
                tim_ids=None, tim_mask=None, tim_token_type_ids=None,
                iadds_task=False, vision_hidden=None, vision_pooled=None,
                tim_src=None, gen=None):
        b = ids.shape[0]
        use_tim = tim_ids is not None or tim_src is not None
        if tim_ids is not None:
            ids = torch.cat([ids, tim_ids], 0)
            attention_mask = torch.cat([attention_mask, tim_mask], 0)
            if token_type_ids is not None:
                token_type_ids = torch.cat([token_type_ids, tim_token_type_ids], 0)
        text_hidden, text_pooled = self.dual.encode_text(ids, attention_mask,
                                                         token_type_ids, gen)
        if tim_src is not None:
            text_hidden = torch.cat([text_hidden, text_hidden[tim_src]], 0)
            text_pooled = torch.cat([text_pooled, text_pooled[tim_src]], 0)
        if vision_hidden is None:
            vision_hidden, vision_pooled = self.dual.encode_vision(pixel_values, gen)
        logits_per_text = self.dual.logits_per_text(text_pooled[:b], vision_pooled)
        if use_tim:
            vh = torch.cat([vision_hidden, vision_hidden], 0)
            vp = torch.cat([vision_pooled, vision_pooled], 0)
        else:
            vh, vp = vision_hidden, vision_pooled
        fused_all = self.fusion(text_hidden, vh, text_pooled, vp)
        fused = fused_all[:b]
        dropped = dropout(fused, self.dropout, self.training, gen)
        out_cls = self.linear_cls(dropped.float())
        out_tim = self.linear_tim(fused_all[b:].float()) if use_tim else None
        out_iadds = self.linear_iadds(dropped.float()) if iadds_task else None
        return {
            "out_cls": out_cls,
            "logits_per_text": logits_per_text,
            "out_tim": out_tim,
            "out_iadds": out_iadds,
            "mm_features": fused,
        }
