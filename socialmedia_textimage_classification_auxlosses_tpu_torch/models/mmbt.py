"""MMBT early fusion: a ResNet's region tokens inside a BERT sequence.

Counterpart of the JAX package's ``models/mmbt.py`` (the supervised
multimodal bitransformer, which the reference declares through its
``MMBT_Dataset`` and ``results_dir_mmbt`` but ships no model for):

* the ResNet trunk (``models/resnet.py``, ``cnn``) in the activation dtype,
  its final feature map average-pooled into ``num_image_embeds`` row bins
  (``adaptive_avg_pool_rows``, torch's ``AdaptiveAvgPool2d((n, 1))``
  boundaries) and projected to the hidden width (``img_proj``);
* the joint sequence ``[CLS] img_1..img_n [SEP] sentence``: the tokenized
  text's leading token and last valid token delimit the image span
  (``split_mmbt_inputs``), embedded through the backbone's own word table
  (``word``), with token types 0 for the image span and 1 for the sentence;
  the position, type and LayerNorm embeddings of ``TextEmbeddings`` (which
  holds no word table here) and a post-LN BERT stack and pooler over it;
  with 128 text tokens the sequence is 5 + 127 = 132 long;
* the heads: ``linear`` on dropout(pooled); ITC logits ``exp(logit_scale)``
  times the cosines of the mean-pooled image tokens and the masked
  mean-pooled sentence; a TIM head ``linear_tim`` on the pooled output of a
  joint pass over the swapped sentences, which reuses the image tokens
  (computed once a step; ``tim_batched`` makes that pass and the primary
  one one 2B-row encoder call).

The trunk's BatchNorm statistics train when the forward is given
``train=True`` (flax's ``batch_stats``, outside AdamW), as the trainers ask
when not deterministic. Module names are the flax tree's.
"""

from __future__ import annotations

import torch
from torch import nn

from .encoder import (EncoderConfig, Pooler, TextEmbeddings, TransformerStack, dense,
                      dropout, embed, init_weights)
from .resnet import STAGE_SIZES, ResNet


def adaptive_avg_pool_rows(fmap: torch.Tensor, n_out: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d((n_out, 1))`` over an NHWC feature map:
    the columns averaged, the rows pooled into ``n_out`` bins from
    floor(i·H/n) to ceil((i+1)·H/n) (bins may overlap). (B, n_out, C)."""
    _, h, _, _ = fmap.shape
    cols = fmap.mean(dim=2)
    rows = [cols[:, (i * h) // n_out: -(-((i + 1) * h) // n_out), :].mean(dim=1)
            for i in range(n_out)]
    return torch.stack(rows, dim=1)


def split_mmbt_inputs(ids: torch.Tensor, attention_mask: torch.Tensor):
    """A tokenized batch as the reference ``MMBT_Dataset``'s fields: the
    leading token (``image_start_token``), the sentence and its mask (the
    rest), and the last valid token (``image_end_token``)."""
    start = ids[:, 0]
    last = torch.clamp(attention_mask.sum(dim=1) - 1, min=0).long()
    end = torch.gather(ids, 1, last[:, None])[:, 0]
    return start, ids[:, 1:], attention_mask[:, 1:], end


class MmbtBackbone(nn.Module):
    def __init__(self, cfg: EncoderConfig, cnn_name: str = "resnet152",
                 num_image_embeds: int = 3):
        super().__init__()
        self.cfg = cfg
        self.num_image_embeds = num_image_embeds
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden)
        # its fc head is computed and never read, as in the JAX module
        self.cnn = ResNet(STAGE_SIZES[cnn_name], 2, dtype=cfg.dtype)
        self.img_proj = nn.Linear(self.cnn.fc.in_features, cfg.hidden)
        self.embeddings = TextEmbeddings(cfg, word_table=False)
        self.encoder = TransformerStack(cfg)
        self.pooler = Pooler(cfg)

    def encode_image(self, pixel_values, train: bool = False):
        """The image's region tokens (B, n, hidden) in the activation dtype."""
        _, fmap = self.cnn(pixel_values, train, return_features=True)
        pooled = adaptive_avg_pool_rows(fmap.permute(0, 2, 3, 1), self.num_image_embeds)
        return dense(self.img_proj, pooled, self.cfg.torch_dtype)

    def joint(self, start_ids, sentence_ids, sentence_mask, end_ids, img_tokens, gen=None):
        """[word(start), image tokens, word(end), word(sentence)] through the
        encoder: (hidden, pooled, n_modal), n_modal the image span's length
        with its delimiters."""
        dt = self.cfg.torch_dtype
        w = self.word.weight
        b = start_ids.shape[0]
        modal = torch.cat([embed(start_ids[:, None], w).to(dt), img_tokens.to(dt),
                           embed(end_ids[:, None], w).to(dt)], dim=1)
        joint = torch.cat([modal, embed(sentence_ids, w).to(dt)], dim=1)
        n_modal, length = modal.shape[1], joint.shape[1]
        dev = joint.device
        shape_ids = torch.zeros(b, length, dtype=torch.long, device=dev)
        token_type = torch.cat([torch.zeros(b, n_modal, dtype=torch.long, device=dev),
                                torch.ones(b, length - n_modal, dtype=torch.long, device=dev)],
                               dim=1)
        emb = self.embeddings(shape_ids, token_type, gen, word_embeds=joint)
        jmask = torch.cat([torch.ones(b, n_modal, dtype=torch.int32, device=dev),
                           sentence_mask.to(torch.int32)], dim=1)
        hidden = self.encoder(emb, jmask, gen)
        return hidden, self.pooler(hidden), n_modal


class MmbtClassifier(nn.Module):
    """MMBT with the trainers' output contract (``out_cls``,
    ``logits_per_text``, ``out_tim``)."""

    def __init__(self, cfg: EncoderConfig, num_labels: int, cnn_name: str = "resnet152",
                 num_image_embeds: int = 3, dropout: float = 0.05,
                 logit_scale_init: float = 2.6592, tim_batched: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dropout = dropout
        self.logit_scale_init = logit_scale_init
        self.tim_batched = tim_batched
        self.backbone = MmbtBackbone(cfg, cnn_name=cnn_name, num_image_embeds=num_image_embeds)
        self.linear = nn.Linear(cfg.hidden, num_labels)
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale_init)))
        self.linear_tim = nn.Linear(cfg.hidden, 2)

    def forward(self, ids, attention_mask, pixel_values, tim_ids=None, tim_mask=None,
                train: bool = False, gen=None):
        bb = self.backbone
        start, sentence, smask, end = split_mmbt_inputs(ids, attention_mask)
        img_tokens = bb.encode_image(pixel_values, train=train)
        tim_pooled = None
        if tim_ids is not None and self.tim_batched:
            t_start, t_sent, t_smask, t_end = split_mmbt_inputs(tim_ids, tim_mask)

            def cat(x, y):
                return torch.cat([x, y], 0)

            b = ids.shape[0]
            hidden2, pooled2, n_modal = bb.joint(
                cat(start, t_start), cat(sentence, t_sent), cat(smask, t_smask),
                cat(end, t_end), cat(img_tokens, img_tokens), gen)
            hidden, pooled, tim_pooled = hidden2[:b], pooled2[:b], pooled2[b:]
        else:
            hidden, pooled, n_modal = bb.joint(start, sentence, smask, end, img_tokens, gen)
            if tim_ids is not None:
                t_start, t_sent, t_smask, t_end = split_mmbt_inputs(tim_ids, tim_mask)
                _, tim_pooled, _ = bb.joint(t_start, t_sent, t_smask, t_end, img_tokens, gen)
        f32 = torch.float32
        out_cls = dense(self.linear, dropout(pooled.float(), self.dropout, self.training, gen),
                        f32)
        # ITC: the image tokens (between the delimiters) against the sentence,
        # both mean-pooled (the sentence over its mask)
        x_v = hidden[:, 1:n_modal - 1, :].float().mean(dim=1)
        tmask = smask.float()[:, :, None]
        x_t = ((hidden[:, n_modal:, :].float() * tmask).sum(dim=1)
               / torch.clamp(tmask.sum(dim=1), min=1.0))
        out_tim = None if tim_pooled is None else dense(self.linear_tim, tim_pooled.float(), f32)
        return {
            "out_cls": out_cls,
            "logits_per_text": self.logits_per_text(x_t, x_v),
            "out_tim": out_tim,
            "out_iadds": None,
            "mm_features": pooled.float(),
        }

    def logits_per_text(self, x_t, x_v):
        t = x_t / torch.linalg.vector_norm(x_t, dim=-1, keepdim=True)
        v = x_v / torch.linalg.vector_norm(x_v, dim=-1, keepdim=True)
        return torch.exp(self.logit_scale) * (t @ v.t())


def init_mmbt_weights(model: MmbtClassifier, generator: torch.Generator) -> None:
    """Random init from ``generator`` after the flax initializers
    (``init_weights``: BatchNorm's constants too), ``logit_scale`` at its
    initial value."""
    init_weights(model, generator)
    with torch.no_grad():
        model.logit_scale.fill_(model.logit_scale_init)
