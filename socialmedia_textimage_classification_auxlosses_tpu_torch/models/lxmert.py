"""LXMERT early fusion over precomputed ROI features.

Counterpart of the JAX package's ``models/lxmert.py`` in its unrolled form
(a ``--scan_layers`` run trains these modules too, and the scanned and
pipeline-padded parameter trees load through ``models/from_jax.py``; the
pipeline schedule is not ported): a language branch of post-LN
self-attention layers over the text, a vision branch over the ROI features
(``VisualFeatEmbeddings``: the features' and the boxes' projections, each
LayerNorm'd, averaged), then cross-modality layers in which each modality
attends to the other through one shared ``cross_attention`` module and one
shared ``ln_cross`` (both directions, the same weights: their gradient is
the sum over the two), followed by each modality's own self-attention and
MLP. Every attention goes through the port's ``Attention``: the SDPA kernel
under ``auto``; under ``fused`` the whole-block kernel for the
self-attentions, while cross-attention keeps the separate projections and
the plain SDPA, as in the JAX package. The vision branch's key mask is all
ones.

The heads are the reference's ``Lxmert`` wrapper's: the first language
token -> ``linear_fusion`` -> ReLU -> dropout -> ``linear``; ITC logits
``exp(logit_scale)`` times the cosines of a masked max-pool over the
language states and a max-pool over the vision states, the language side
detached first (the reference's ``clone().detach()``, the JAX package's
``stop_gradient``: ITC's gradient reaches the model through the vision side
only); a TIM head ``linear_tim`` on the first token of a pass over the
swapped texts, with the same ROI features. ``tim_batched`` (the default)
runs that pass and the primary one as one 2B-row backbone call; every row
sees only its own (text, ROI set), so the math is the two-pass layout's
(``--tim_two_pass``), the dropout masks drawn once over 2B rows.

Dtypes follow the flax modules: the text embeddings and every LayerNorm
return float32, dense layers compute in ``dtype``, the heads in float32.
Module names are the flax tree's, the layer lists ``lang_layers``,
``vis_layers`` and ``x_layers`` (flax ``lang_layer_{i}``, ...).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .encoder import (Attention, EncoderConfig, EncoderLayer, Mlp, TextEmbeddings, dense,
                      dropout, init_weights, layer_norm)


@dataclasses.dataclass(frozen=True)
class LxmertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    l_layers: int = 9
    r_layers: int = 5
    x_layers: int = 5
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4
    dropout: float = 0.1
    ln_eps: float = 1e-12
    dtype: str = "float32"
    attn_impl: str = "auto"

    def encoder_cfg(self) -> EncoderConfig:
        """The BERT-style layers' configuration (post-LN)."""
        return EncoderConfig(
            vocab_size=self.vocab_size, hidden=self.hidden, layers=self.l_layers,
            heads=self.heads, mlp_dim=self.mlp_dim, max_positions=self.max_positions,
            type_vocab=self.type_vocab, dropout=self.dropout, ln_eps=self.ln_eps,
            ln_style="post", dtype=self.dtype, attn_impl=self.attn_impl)


class CrossModalityLayer(nn.Module):
    """One x-layer: the shared cross-attention both ways, then each
    modality's self-attention and MLP, post-LN residuals throughout."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        h = cfg.hidden
        self.cross_attention = Attention(cfg)
        self.ln_cross = nn.LayerNorm(h, eps=cfg.ln_eps)
        self.lang_self = Attention(cfg)
        self.vis_self = Attention(cfg)
        self.ln_self_l = nn.LayerNorm(h, eps=cfg.ln_eps)
        self.ln_self_v = nn.LayerNorm(h, eps=cfg.ln_eps)
        self.lang_mlp = Mlp(cfg)
        self.vis_mlp = Mlp(cfg)
        self.ln_mlp_l = nn.LayerNorm(h, eps=cfg.ln_eps)
        self.ln_mlp_v = nn.LayerNorm(h, eps=cfg.ln_eps)

    def forward(self, lang, vis, lang_mask, vis_mask, gen=None):
        cross = self.cross_attention
        lang2 = layer_norm(self.ln_cross, lang + cross(lang, vis, vis_mask, gen))
        vis2 = layer_norm(self.ln_cross, vis + cross(vis, lang, lang_mask, gen))
        lang3 = layer_norm(self.ln_self_l, lang2 + self.lang_self(lang2, lang2, lang_mask, gen))
        vis3 = layer_norm(self.ln_self_v, vis2 + self.vis_self(vis2, vis2, vis_mask, gen))
        lang4 = layer_norm(self.ln_mlp_l, lang3 + self.lang_mlp(lang3, gen))
        vis4 = layer_norm(self.ln_mlp_v, vis3 + self.vis_mlp(vis3, gen))
        return lang4, vis4


class VisualFeatEmbeddings(nn.Module):
    """ROI features and normalised boxes, each projected and LayerNorm'd,
    averaged, then dropout. The features (float32 on the device) enter the
    projection in ``dtype``."""

    def __init__(self, cfg: EncoderConfig, visual_feat_dim: int = 2048,
                 visual_pos_dim: int = 4):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.feat_proj = nn.Linear(visual_feat_dim, h)
        self.feat_ln = nn.LayerNorm(h, eps=cfg.ln_eps)
        self.pos_proj = nn.Linear(visual_pos_dim, h)
        self.pos_ln = nn.LayerNorm(h, eps=cfg.ln_eps)

    def forward(self, feats, boxes, gen=None):
        cfg = self.cfg
        dt = cfg.torch_dtype
        f = layer_norm(self.feat_ln, dense(self.feat_proj, feats, dt))
        p = layer_norm(self.pos_ln, dense(self.pos_proj, boxes, dt))
        return dropout((f + p) / 2.0, cfg.dropout, self.training, gen)


class LxmertBackbone(nn.Module):
    """(language states, vision states) of a batch of texts and ROI sets."""

    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.cfg = cfg
        ecfg = cfg.encoder_cfg()
        self.embeddings = TextEmbeddings(ecfg)
        self.visual_embeddings = VisualFeatEmbeddings(ecfg, cfg.visual_feat_dim,
                                                      cfg.visual_pos_dim)
        self.lang_layers = nn.ModuleList(EncoderLayer(ecfg) for _ in range(cfg.l_layers))
        self.vis_layers = nn.ModuleList(EncoderLayer(ecfg) for _ in range(cfg.r_layers))
        self.x_layers = nn.ModuleList(CrossModalityLayer(ecfg) for _ in range(cfg.x_layers))

    def forward(self, ids, attention_mask, token_type_ids, visual_feats, visual_pos, gen=None):
        lang = self.embeddings(ids, token_type_ids, gen)
        vis = self.visual_embeddings(visual_feats, visual_pos, gen)
        vis_mask = torch.ones(vis.shape[:2], dtype=torch.int32, device=vis.device)
        for layer in self.lang_layers:
            lang = layer(lang, attention_mask, gen)
        for layer in self.vis_layers:
            vis = layer(vis, vis_mask, gen)
        for layer in self.x_layers:
            lang, vis = layer(lang, vis, attention_mask, vis_mask, gen)
        return lang, vis


class LxmertClassifier(nn.Module):
    """The reference's ``Lxmert`` head stack over ``LxmertBackbone``."""

    def __init__(self, cfg: LxmertConfig, num_labels: int, dropout: float = 0.1,
                 logit_scale_init: float = 2.6592, tim_batched: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dropout = dropout
        self.logit_scale_init = logit_scale_init
        self.tim_batched = tim_batched
        self.backbone = LxmertBackbone(cfg)
        self.linear_fusion = nn.Linear(cfg.hidden, cfg.hidden)
        self.linear = nn.Linear(cfg.hidden, num_labels)
        self.linear_tim = nn.Linear(cfg.hidden, 2)
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale_init)))

    def forward(self, ids, attention_mask, token_type_ids, visual_feats, visual_pos,
                tim_ids=None, tim_mask=None, tim_token_type_ids=None, gen=None):
        lang_tim = None
        if tim_ids is not None and self.tim_batched:
            def cat(x, y):
                return torch.cat([x, y], 0)

            b = ids.shape[0]
            lang2, vis2 = self.backbone(
                cat(ids, tim_ids), cat(attention_mask, tim_mask),
                None if token_type_ids is None else cat(token_type_ids, tim_token_type_ids),
                cat(visual_feats, visual_feats), cat(visual_pos, visual_pos), gen)
            lang, lang_tim, vis = lang2[:b], lang2[b:], vis2[:b]
        else:
            lang, vis = self.backbone(ids, attention_mask, token_type_ids, visual_feats,
                                      visual_pos, gen)
            if tim_ids is not None:
                lang_tim, _ = self.backbone(tim_ids, tim_mask, tim_token_type_ids,
                                            visual_feats, visual_pos, gen)
        f32 = torch.float32
        fused = torch.relu(dense(self.linear_fusion, lang[:, 0, :].float(), f32))
        fused = dropout(fused, self.dropout, self.training, gen)
        out_cls = dense(self.linear, fused, f32)
        # ITC: masked max-pool over the DETACHED language states, max-pool
        # over the vision states (amax: ties share the gradient, as jnp.max)
        neg = torch.full((), -1e9, dtype=lang.dtype, device=lang.device)  # no host copy
        x_t = torch.amax(torch.where(attention_mask[:, :, None] > 0, lang.detach(), neg), dim=1)
        x_v = torch.amax(vis, dim=1)
        out_tim = None
        if lang_tim is not None:
            out_tim = dense(self.linear_tim, lang_tim[:, 0, :].float(), f32)
        return {
            "out_cls": out_cls,
            "logits_per_text": self.logits_per_text(x_t, x_v),
            "out_tim": out_tim,
            "out_iadds": None,
            "mm_features": fused,
        }

    def logits_per_text(self, x_t, x_v):
        t = x_t.float()
        v = x_v.float()
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return torch.exp(self.logit_scale) * (t @ v.t())


def init_lxmert_weights(model: LxmertClassifier, generator: torch.Generator) -> None:
    """Random init from ``generator`` after the flax initializers
    (``init_weights``), ``logit_scale`` at its initial value."""
    init_weights(model, generator)
    with torch.no_grad():
        model.logit_scale.fill_(model.logit_scale_init)
