"""Text tower configurations.

Counterpart of the JAX package's ``models/text.py`` (configuration part).
Hyperparameters come from the presets below; when a local pretrained
directory holds a ``config.json`` its dimensions win, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .encoder import EncoderConfig

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
