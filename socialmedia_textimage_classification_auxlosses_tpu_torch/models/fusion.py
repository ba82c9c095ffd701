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
``gen`` and is the identity in eval mode.

``MMCnnModel`` is the CNN fusion path (``concat_cnn`` / ``xatt``): a
BERT-family text tower and a ResNet trunk in float32 whatever the text
tower's dtype, as the JAX module builds its trunk without one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .dual import DualEncoder
from .encoder import (BertEncoder, EncoderConfig, dense, dropout, linear, seed_cat, seed_count,
                      seed_head, seed_tail)
from .resnet import STAGE_SIZES, ResNet

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
    features are computed once and shared, or come in as ``vision_hidden``
    / ``vision_pooled`` (``--cache_vision``). ``word_embeds`` /
    ``tim_word_embeds`` replace the text tower's word lookup for the first
    and the TIM texts (a lazy-AdamW step's injected rows).

    Seed-stacked (``models/encoder.py::stack_seed_models``), every input and
    output is seed-major: S·B rows of ids, pixels and ``tim_*`` (``tim_src``
    indexing all S·B rows), each seed's TIM rows after its own first-pass
    rows through the text tower and the fusion head, ``logits_per_text``
    (S·B, B)."""

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
                tim_src=None, gen=None, word_embeds=None, tim_word_embeds=None):
        b = ids.shape[0]
        s = seed_count(self.linear_cls.weight, 2)
        use_tim = tim_ids is not None or tim_src is not None
        if tim_ids is not None:
            ids = seed_cat(ids, tim_ids, s)
            attention_mask = seed_cat(attention_mask, tim_mask, s)
            if token_type_ids is not None:
                token_type_ids = seed_cat(token_type_ids, tim_token_type_ids, s)
            if word_embeds is not None:
                word_embeds = seed_cat(word_embeds, tim_word_embeds, s)
        text_hidden, text_pooled = self.dual.encode_text(ids, attention_mask,
                                                         token_type_ids, gen, word_embeds)
        if tim_src is not None:
            text_hidden = seed_cat(text_hidden, text_hidden[tim_src], s)
            text_pooled = seed_cat(text_pooled, text_pooled[tim_src], s)
        if vision_hidden is None:
            vision_hidden, vision_pooled = self.dual.encode_vision(pixel_values, gen)
        logits_per_text = self.dual.logits_per_text(seed_head(text_pooled, s, b),
                                                    vision_pooled)
        if use_tim:
            vh = seed_cat(vision_hidden, vision_hidden, s)
            vp = seed_cat(vision_pooled, vision_pooled, s)
        else:
            vh, vp = vision_hidden, vision_pooled
        fused_all = self.fusion(text_hidden, vh, text_pooled, vp)
        fused = seed_head(fused_all, s, b)
        dropped = dropout(fused, self.dropout, self.training, gen)
        out_cls = linear(self.linear_cls, dropped.float())
        out_tim = linear(self.linear_tim, seed_tail(fused_all, s, b).float()) if use_tim else None
        out_iadds = linear(self.linear_iadds, dropped.float()) if iadds_task else None
        return {
            "out_cls": out_cls,
            "logits_per_text": logits_per_text,
            "out_tim": out_tim,
            "out_iadds": out_iadds,
            "mm_features": fused,
        }


class MMCnnModel(nn.Module):
    """Text tower + ResNet trunk, the JAX ``MMCnnModel``. The final 7x7
    conv map (float32) is projected to the text width (``conv_proj``, 49
    tokens); ``concat_cnn`` concatenates the text CLS with the tokens' mean,
    ``xatt`` with the CLS query's single-head attention over the tokens,
    computed inline in float32 (the JAX module's ``impl="jnp"``, no
    kernel); then ``linear_fusion`` + ReLU, the head dropout and
    ``linear_cls``. ``forward(..., train)`` trains the trunk's BatchNorm
    statistics (the JAX ``train``; dropout follows the module's mode). The
    trunk's ``fc`` is built and never read, as in the JAX module, so it
    decays under AdamW without a gradient."""

    def __init__(self, text_cfg: EncoderConfig, cnn_name: str, num_labels: int,
                 fusion_name: str = "concat_cnn", dropout: float = 0.05):
        super().__init__()
        if fusion_name not in ("concat_cnn", "xatt"):
            raise ValueError(f"unknown CNN fusion {fusion_name}")
        self.text_cfg = text_cfg
        self.fusion_name = fusion_name
        self.dropout = dropout
        h = text_cfg.hidden
        self.text = BertEncoder(text_cfg)
        self.cnn = ResNet(STAGE_SIZES[cnn_name], num_labels)
        self.conv_proj = nn.Linear(self.cnn.fc.in_features, h)
        self.linear_fusion = nn.Linear(2 * h, h)
        self.linear_cls = nn.Linear(h, num_labels)

    def forward(self, ids, attention_mask, pixel_values, token_type_ids=None,
                train: bool = False, gen=None, word_embeds=None):
        text_hidden, text_pooled = self.text(ids, attention_mask, token_type_ids, gen,
                                             word_embeds)
        _, fmap = self.cnn(pixel_values, train, return_features=True)
        conv_tokens = self.conv_proj(fmap.flatten(2).transpose(1, 2).float())
        cls = text_hidden[:, 0, :].float()
        if self.fusion_name == "xatt":
            scores = torch.bmm(cls[:, None, :], conv_tokens.transpose(1, 2)) * cls.shape[-1] ** -0.5
            ctx = torch.bmm(torch.softmax(scores, dim=-1), conv_tokens)[:, 0, :]
            feat = torch.cat([cls, ctx], -1)
        else:  # concat_cnn
            feat = torch.cat([cls, conv_tokens.mean(dim=1)], -1)
        fused = dropout(F.relu(self.linear_fusion(feat)), self.dropout, self.training, gen)
        return {"out_cls": self.linear_cls(fused), "text_pooled": text_pooled,
                "mm_features": fused}
