"""Shared transformer encoder core.

Counterpart of the JAX package's ``models/encoder.py``. One stack covers the
BERT/RoBERTa/Bernice text towers (post-LN, learned positions, RoBERTa-style
position offset) and the ViT/DEiT image towers (pre-LN over patches).

Module and parameter names follow the flax tree (``query``/``key``/
``value``/``out``, ``mlp_in``/``mlp_out``, ``ln_attn``/``ln_mlp``), so
``models/from_jax.py`` maps a JAX parameter tree onto these modules name by
name; ``layer_{i}`` becomes ``layers.{i}``.

Dtypes follow the flax modules exactly, because the bf16 comparison with the
JAX package drifts otherwise:

* activations run in ``cfg.dtype``; every dense layer casts its input, weight
  and bias to it, rounds the product and then the bias sum (flax ``Dense``);
* LayerNorms compute and return float32, so the text tower's residual stream
  is float32 after its first LayerNorm while the ViT stream stays in
  ``cfg.dtype`` until ``ln_final``;
* GELU is exact (erf).

Dropout sits where the flax modules put it: after the embedding LayerNorm,
on the attention block's output, on the MLP's output and after the ViT patch
embeddings (no dropout on the attention probabilities). It is
``dropout(x, rate, training, gen)``: active only while the module is in
training mode, drawing from the explicit ``torch.Generator`` handed down the
forward (``gen``); under ``model.eval()`` it is the identity. The draws
differ from JAX's for the same seed, so tests that compare the two run at
rate 0 or feed both sides the same masks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    ln_eps: float = 1e-12
    # position ids: RoBERTa-family offsets past pad_token_id
    pos_offset: int = 0
    pad_token_id: int = 0
    hidden_act: str = "gelu"  # exact (erf) gelu, as BERT/ViT
    ln_style: str = "post"  # "post" (BERT) or "pre" (ViT)
    dtype: str = "float32"
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def activation(self, x):
        if self.hidden_act == "gelu":
            return F.gelu(x, approximate="none")
        if self.hidden_act == "gelu_new":
            return F.gelu(x, approximate="tanh")
        if self.hidden_act == "relu":
            return F.relu(x)
        raise ValueError(self.hidden_act)


def dropout(x: torch.Tensor, rate: float, training: bool,
            gen: torch.Generator = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each value with probability ``1 - rate`` and
    scale the kept ones by ``1 / (1 - rate)``; the identity when not training
    or at rate 0. The mask is drawn from ``gen`` (on x's device)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, weight and bias cast to ``dtype``;
    the product is rounded to ``dtype`` before the bias is added."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: statistics and output in float32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


class Attention(nn.Module):
    """Multi-head attention over separate query / key-value streams.

    ``cfg.attn_impl``:
      * "auto" / "pallas" / "pallas_interpret" / "jnp": separate projections +
        ``ops.attention.sdpa``, which launches the SDPA kernel on a CUDA
        tensor ("jnp" asks for the plain version);
      * "fused" / "fused_interpret": self-attention runs as the whole-block
        kernel ``ops.attn_block.attn_block``; cross-attention keeps the
        separate path with the plain SDPA, as in the JAX package.
    """

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)

    def forward(self, q_input, kv_input, key_mask=None, gen=None):
        cfg = self.cfg
        dt = cfg.torch_dtype
        b, lq, _ = q_input.shape
        if cfg.attn_impl in ("fused", "fused_interpret") and q_input is kv_input:
            from ..ops.attn_block import attn_block

            # .t() of a Linear weight is the flax (in, out) layout, as a view
            w = [lin.weight.to(dt).t() for lin in (self.query, self.key,
                                                 self.value, self.out)]
            bias = [lin.bias.to(dt) for lin in (self.query, self.key,
                                              self.value, self.out)]
            out = attn_block(q_input.to(dt), key_mask, w[0], bias[0], w[1],
                             bias[1], w[2], bias[2], w[3], bias[3],
                             heads=cfg.heads, impl=cfg.attn_impl)
            return dropout(out, cfg.dropout, self.training, gen)

        def split(x):
            return x.reshape(b, -1, cfg.heads, cfg.head_dim).transpose(1, 2)

        q = split(dense(self.query, q_input, dt))
        k = split(dense(self.key, kv_input, dt))
        v = split(dense(self.value, kv_input, dt))
        sdpa_impl = ("jnp" if cfg.attn_impl in ("fused", "fused_interpret")
                     else cfg.attn_impl)
        ctx = sdpa(q, k, v, key_mask=key_mask, impl=sdpa_impl)
        ctx = ctx.transpose(1, 2).reshape(b, lq, cfg.hidden)
        return dropout(dense(self.out, ctx, dt), cfg.dropout, self.training, gen)


class Mlp(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.mlp_in = nn.Linear(cfg.hidden, cfg.mlp_dim)
        self.mlp_out = nn.Linear(cfg.mlp_dim, cfg.hidden)

    def forward(self, x, gen=None):
        dt = self.cfg.torch_dtype
        h = dense(self.mlp_out, self.cfg.activation(dense(self.mlp_in, x, dt)), dt)
        return dropout(h, self.cfg.dropout, self.training, gen)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = Attention(cfg)
        self.mlp = Mlp(cfg)
        self.ln_attn = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        self.ln_mlp = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)

    def forward(self, x, key_mask=None, gen=None):
        if self.cfg.ln_style == "post":  # BERT family
            x = layer_norm(self.ln_attn, x + self.attention(x, x, key_mask, gen))
            return layer_norm(self.ln_mlp, x + self.mlp(x, gen))
        h = layer_norm(self.ln_attn, x)  # pre-LN, ViT family
        x = x + self.attention(h, h, key_mask, gen)
        return x + self.mlp(layer_norm(self.ln_mlp, x), gen)


class TransformerStack(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.layers))

    def forward(self, x, key_mask=None, gen=None):
        for layer in self.layers:
            x = layer(x, key_mask, gen)
        return x


class Pooler(nn.Module):
    """CLS dense + tanh pooler (BERT/ViT/DEiT convention)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(cfg.hidden, cfg.hidden)

    def forward(self, hidden):
        return torch.tanh(dense(self.dense, hidden[:, 0, :], self.cfg.torch_dtype))


class TextEmbeddings(nn.Module):
    """Word + position + (optional) token-type embeddings, then LayerNorm."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position = nn.Embedding(cfg.max_positions, cfg.hidden)
        self.token_type = (nn.Embedding(cfg.type_vocab, cfg.hidden)
                           if cfg.type_vocab else None)
        self.ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)

    def forward(self, ids, token_type_ids=None, gen=None):
        cfg = self.cfg
        dt = cfg.torch_dtype
        emb = F.embedding(ids, self.word.weight).to(dt)
        if cfg.pos_offset:
            # RoBERTa family: positions count non-pad tokens, offset past the
            # pad id (the JAX package's formula, kept as it is)
            mask = (ids != cfg.pad_token_id).to(ids.dtype)
            pos_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        else:
            pos_ids = torch.arange(ids.shape[1], device=ids.device)[None, :]
        emb = emb + F.embedding(pos_ids, self.position.weight).to(dt)
        if self.token_type is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(ids)
            emb = emb + F.embedding(token_type_ids, self.token_type.weight).to(dt)
        return dropout(layer_norm(self.ln, emb), cfg.dropout, self.training, gen)


class BertEncoder(nn.Module):
    """BERT/RoBERTa/Bernice tower: embeddings -> post-LN stack -> pooler.
    Returns (last_hidden, pooled)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = TransformerStack(cfg)
        self.pooler = Pooler(cfg)

    def forward(self, ids, attention_mask=None, token_type_ids=None, gen=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(ids)
        x = self.embeddings(ids, token_type_ids, gen)
        x = self.encoder(x, attention_mask, gen)
        return x, self.pooler(x)


class PatchEmbeddings(nn.Module):
    """Image -> patch tokens (+CLS, +optional distillation token) + positions.

    Takes NHWC pixels, as the JAX module does (NCHW is accepted too, told
    apart by the channel axis)."""

    def __init__(self, cfg: EncoderConfig, patch: int = 16, image_size: int = 224,
                 channels: int = 3, num_prefix_tokens: int = 1):
        super().__init__()
        self.cfg = cfg
        self.channels = channels
        self.proj = nn.Conv2d(channels, cfg.hidden, patch, stride=patch)
        self.prefix_tokens = nn.Parameter(torch.zeros(1, num_prefix_tokens, cfg.hidden))
        n = (image_size // patch) ** 2 + num_prefix_tokens
        self.pos_embed = nn.Parameter(torch.zeros(1, n, cfg.hidden))

    def forward(self, pixel_values, gen=None):
        dt = self.cfg.torch_dtype
        b = pixel_values.shape[0]
        if pixel_values.shape[1] != self.channels:
            pixel_values = pixel_values.permute(0, 3, 1, 2)  # NHWC -> NCHW
        p = self.proj
        x = F.conv2d(pixel_values.to(dt), p.weight.to(dt), None, p.stride)
        x = x + p.bias.to(dt)[:, None, None]
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major
        prefix = self.prefix_tokens.to(dt).expand(b, -1, -1)
        x = torch.cat([prefix, x], dim=1) + self.pos_embed.to(dt)
        return dropout(x, self.cfg.dropout, self.training, gen)


class ViTEncoder(nn.Module):
    """ViT/DEiT tower: patches -> pre-LN stack -> final LN -> pooler.

    ``pooling``: "tanh" (ViT/DEiT pooler) or "none"."""

    def __init__(self, cfg: EncoderConfig, patch: int = 16, image_size: int = 224,
                 num_prefix_tokens: int = 1, pooling: str = "tanh"):
        super().__init__()
        if pooling not in ("tanh", "none"):
            raise ValueError(f"ViTEncoder pooling {pooling!r} is not ported")
        self.cfg = cfg
        self.pooling = pooling
        self.embeddings = PatchEmbeddings(cfg, patch=patch, image_size=image_size,
                                          num_prefix_tokens=num_prefix_tokens)
        self.encoder = TransformerStack(cfg)
        self.ln_final = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        self.pooler = Pooler(cfg) if pooling == "tanh" else None

    def forward(self, pixel_values, gen=None):
        x = self.embeddings(pixel_values, gen)
        x = self.encoder(x, None, gen)
        x = layer_norm(self.ln_final, x)
        pooled = self.pooler(x) if self.pooler is not None else x[:, 0, :]
        return x, pooled


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``, after flax's initializers: dense and
    conv weights lecun-normal (std 1/sqrt(fan_in)), biases zero, embeddings
    normal with std 1/sqrt(width), LayerNorm scale one, ``pos_embed`` normal
    0.02, ``prefix_tokens`` zero. The JAX package draws other numbers from
    the same seed: tests carry weights across with ``models/from_jax.py``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, PatchEmbeddings):
                m.pos_embed.normal_(0.0, 0.02, generator=generator)
                m.prefix_tokens.zero_()
