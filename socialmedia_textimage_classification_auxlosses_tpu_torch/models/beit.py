"""BEiT vision tower.

Counterpart of the JAX package's ``models/beit.py``: no absolute position
embeddings, a per-layer relative position bias added to the attention scores
(with its own cls<->patch and cls<->cls entries), no key-projection bias,
layer-scale residual gains ``lambda_1``/``lambda_2`` and the pooled output
``pool_ln`` over the mean of the patch tokens.

The attention is computed here with ``torch.matmul`` and ``softmax``, as the
JAX module computes it outside any Pallas kernel: the scores rounded to the
activation dtype after the scale, the bias added in float32, the softmax in
float32, the probabilities cast back before ``P·V``. The port's SDPA kernels
take no additive bias, so BEiT launches none of them.

Names follow the flax tree (``layer_{i}`` becomes ``layers.{i}``), so
``models/from_jax.py`` carries a JAX parameter tree across.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .encoder import EncoderConfig, Mlp, add_bias, dense, dropout, layer_norm


def beit_relative_position_index(grid: int) -> np.ndarray:
    """(N, N) index into the relative-position-bias table for N = grid^2 + 1
    tokens (cls first), as HF ``BeitRelativePositionBias`` builds it."""
    num_rel = (2 * grid - 1) ** 2 + 3
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += grid - 1
    rel[:, :, 1] += grid - 1
    rel[:, :, 0] *= 2 * grid - 1
    n = grid * grid
    index = np.zeros((n + 1, n + 1), np.int32)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel - 3
    index[0:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index


class BeitAttention(nn.Module):
    """Multi-head self-attention with the relative position bias; the key
    projection has no bias."""

    def __init__(self, cfg: EncoderConfig, grid: int):
        super().__init__()
        self.cfg, self.grid = cfg, grid
        h = cfg.hidden
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h, bias=False)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)
        self.rel_pos_table = nn.Parameter(torch.zeros((2 * grid - 1) ** 2 + 3, cfg.heads))
        # the bias gather's index, a constant kept out of the state dict (the
        # JAX tree has none): on the host, and once per device it runs on, so
        # a CUDA graph that captures the forward reads the same tensor
        self.index = torch.from_numpy(beit_relative_position_index(grid).astype(np.int64))
        self._index_on = {}

    def init_constants(self) -> None:
        self.rel_pos_table.zero_()

    def forward(self, x, gen=None):
        cfg = self.cfg
        dt = cfg.torch_dtype
        b, n, _ = x.shape

        def split(t):
            return t.reshape(b, n, cfg.heads, cfg.head_dim).transpose(1, 2)

        q = split(dense(self.query, x, dt))
        k = split(dense(self.key, x, dt))
        v = split(dense(self.value, x, dt))
        index = self._index_on.get(x.device)
        if index is None:
            index = self._index_on[x.device] = self.index.to(x.device)
        bias = self.rel_pos_table[index]  # (N, N, heads)
        bias = bias.permute(2, 0, 1)[None]
        scores = torch.matmul(q, k.transpose(-1, -2)) * cfg.head_dim ** -0.5
        probs = torch.softmax(scores.float() + bias.float(), dim=-1).to(q.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, cfg.hidden)
        return dropout(dense(self.out, ctx, dt), cfg.dropout, self.training, gen)


class BeitLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, grid: int, layer_scale_init: float = 0.1):
        super().__init__()
        self.cfg = cfg
        self.layer_scale_init = layer_scale_init
        self.lambda_1 = nn.Parameter(torch.full((cfg.hidden,), layer_scale_init))
        self.lambda_2 = nn.Parameter(torch.full((cfg.hidden,), layer_scale_init))
        self.attention = BeitAttention(cfg, grid)
        self.mlp = Mlp(cfg)
        self.ln_attn = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        self.ln_mlp = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)

    def init_constants(self) -> None:
        self.lambda_1.fill_(self.layer_scale_init)
        self.lambda_2.fill_(self.layer_scale_init)

    def forward(self, x, gen=None):
        x = x + self.lambda_1.to(x.dtype) * self.attention(layer_norm(self.ln_attn, x), gen)
        return x + self.lambda_2.to(x.dtype) * self.mlp(layer_norm(self.ln_mlp, x), gen)


class BeitEncoder(nn.Module):
    """Patches (+cls) -> BEiT layers; returns (last_hidden, pooled), pooled =
    LayerNorm(mean of the patch tokens) in float32. Takes NHWC pixels (NCHW
    too, told apart by the channel axis)."""

    def __init__(self, cfg: EncoderConfig, patch: int = 16, image_size: int = 224):
        super().__init__()
        self.cfg = cfg
        grid = image_size // patch
        self.proj = nn.Conv2d(3, cfg.hidden, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden))
        self.layers = nn.ModuleList(BeitLayer(cfg, grid) for _ in range(cfg.layers))
        self.pool_ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)

    def init_constants(self) -> None:
        self.cls_token.zero_()

    def forward(self, pixel_values, gen=None):
        cfg = self.cfg
        dt = cfg.torch_dtype
        b = pixel_values.shape[0]
        if pixel_values.shape[1] != 3:
            pixel_values = pixel_values.permute(0, 3, 1, 2)  # NHWC -> NCHW
        p = self.proj
        x = F.conv2d(pixel_values.to(dt), p.weight.to(dt), None, p.stride)
        if len(self.layers) and x.shape[-1] != self.layers[0].attention.grid:
            raise ValueError(f"a {x.shape[-1]}-patch grid side for a tower built for "
                             f"{self.layers[0].attention.grid}")
        x = add_bias(x.flatten(2).transpose(1, 2), p.bias.to(dt))
        x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1), x], dim=1)
        x = dropout(x, cfg.dropout, self.training, gen)
        for layer in self.layers:
            x = layer(x, gen)
        return x, layer_norm(self.pool_ln, x[:, 1:, :].mean(dim=1))
