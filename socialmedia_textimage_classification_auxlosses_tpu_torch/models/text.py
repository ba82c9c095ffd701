"""Text tower configurations and the text-only classifier.

Counterpart of the JAX package's ``models/text.py``. Hyperparameters come
from the presets below; when a local pretrained directory holds a
``config.json`` its dimensions win, as in the JAX package.
``TextClassifier`` is the tower plus a linear head (``cli/run_txt.py``),
with the JAX module's names (``tower``, ``classifier``), so
``models/from_jax.py`` carries a JAX ``TextClassifier`` tree across.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
from torch import nn

from .encoder import BertEncoder, EncoderConfig, dense, dropout

# Architecture presets (dimensions per the public model cards).
TEXT_PRESETS = {
    "bert": dict(vocab_size=30522, max_positions=512, type_vocab=2,
                 pos_offset=0, pad_token_id=0),
    "bertweet": dict(vocab_size=64001, max_positions=130, type_vocab=1,
                     pos_offset=2, pad_token_id=1),
    "roberta": dict(vocab_size=50265, max_positions=514, type_vocab=1,
                    pos_offset=2, pad_token_id=1),
    "bernice": dict(vocab_size=250002, max_positions=514, type_vocab=1,
                    pos_offset=2, pad_token_id=1),
}

# Model names whose tokenizer produces no token_type_ids.
NO_TOKEN_TYPES = {"roberta", "bernice"}


def _load_hf_config(model_dir: Optional[str]) -> dict:
    if model_dir:
        path = os.path.join(model_dir, "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
    return {}


def text_encoder_config(
    model_name: str,
    model_dir: Optional[str] = None,
    dtype: str = "float32",
    dropout: float = 0.1,
    attn_impl: str = "auto",
    **overrides,
) -> EncoderConfig:
    preset = dict(TEXT_PRESETS[model_name])
    hf = _load_hf_config(model_dir)
    if hf:
        preset.update(
            vocab_size=hf.get("vocab_size", preset["vocab_size"]),
            max_positions=hf.get("max_position_embeddings", preset["max_positions"]),
            type_vocab=hf.get("type_vocab_size", preset["type_vocab"]),
            pad_token_id=hf.get("pad_token_id", preset["pad_token_id"]),
        )
        overrides.setdefault("hidden", hf.get("hidden_size", 768))
        overrides.setdefault("layers", hf.get("num_hidden_layers", 12))
        overrides.setdefault("heads", hf.get("num_attention_heads", 12))
        overrides.setdefault("mlp_dim", hf.get("intermediate_size", 3072))
        overrides.setdefault("ln_eps", hf.get("layer_norm_eps", 1e-12))
        dropout = hf.get("hidden_dropout_prob", dropout)
    preset.update(overrides)
    return EncoderConfig(dropout=dropout, ln_style="post", dtype=dtype,
                         attn_impl=attn_impl, **preset)


class TextClassifier(nn.Module):
    """Tower + linear classification head; returns float32 logits.

    ``use_pooled`` selects the RoBERTa head (the pooled output) over the CLS
    of the last hidden state that bert, bertweet and bernice use. The head's
    dropout (``--dropout``) acts on that feature, drawing from ``gen``."""

    def __init__(self, cfg: EncoderConfig, num_labels: int, head_dropout: float = 0.1,
                 use_pooled: bool = False):
        super().__init__()
        self.cfg = cfg
        self.head_dropout = head_dropout
        self.use_pooled = use_pooled
        self.tower = BertEncoder(cfg)
        self.classifier = nn.Linear(cfg.hidden, num_labels)

    def forward(self, ids, attention_mask=None, token_type_ids=None, gen=None,
                word_embeds=None):
        hidden, pooled = self.tower(ids, attention_mask, token_type_ids, gen, word_embeds)
        feat = pooled if self.use_pooled else hidden[:, 0, :]
        feat = dropout(feat, self.head_dropout, self.training, gen)
        return dense(self.classifier, feat.float(), torch.float32)


def build_text_classifier(model_name: str, num_labels: int,
                          model_dir: Optional[str] = None, dropout: float = 0.1,
                          dtype: str = "float32", attn_impl: str = "auto",
                          **overrides) -> TextClassifier:
    """The JAX ``build_text_classifier``: the tower of ``model_name`` and the
    pooled head for ``roberta``, the CLS head otherwise."""
    cfg = text_encoder_config(model_name, model_dir, dtype=dtype, attn_impl=attn_impl,
                              **overrides)
    return TextClassifier(cfg, num_labels, head_dropout=dropout,
                          use_pooled=model_name == "roberta")
