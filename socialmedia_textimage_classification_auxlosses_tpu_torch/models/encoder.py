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

Seed-stacked models (``stack_seed_models``; the multi-seed sweep of
``train/ensemble.py``) carry one more leading axis S on every parameter, one
slice per seed, and take activations seed-major: S·B rows, seed 0's B rows
first. The helpers every module shares read S from the parameter and keep
each seed's rows with its own slice: ``dense`` is one ``bmm`` over (S, rows,
in) with the product rounded before the bias, as flax rounds; ``linear``
(torch's Linear) one ``baddbmm``; both through ``SeedProduct``, whose
backward leaves each weight gradient in its parameter's layout;
``layer_norm`` normalises once and applies each seed's scale and bias;
``embed`` gathers from the (S·V, E) view at each row's seed offset; the
patch projection is one convolution per seed. The
attention's SDPA takes the S·B rows as its batch; the whole-block kernel
runs once per seed on that seed's rows and weights. ``dropout`` draws each
seed's mask from that seed's generator (``gen`` a tuple of S generators),
in the order the seed's own run draws it. A plain model is the case S = 0:
every helper is then the call it always was.

``remat`` (``--remat``, the JAX encoders' ``remat``) recomputes each layer
in the backward instead of keeping its activations
(``torch.utils.checkpoint``). ``checkpoint``'s RNG preservation covers the
global generators only, not the explicit ``gen``, so a layer's two dropout
masks are drawn from ``gen`` before the layer runs, in the order the layer
would draw them, and handed to both the forward and the recompute
(``DrawnMasks``): the masks, and so the gradients, are those of the run
without ``remat``, and no generator state is read or set (a CUDA graph
captures the step as it is).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    remat: bool = False  # recompute each layer in the backward

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


class DrawnMasks:
    """Keep-masks drawn ahead of a rematerialised layer, given out in the
    order they were drawn; ``dropout`` takes one in place of a draw."""

    def __init__(self, masks):
        self.masks = list(masks)

    def take(self) -> torch.Tensor:
        return self.masks.pop(0)


def keep_mask(shape, rate: float, gen, device) -> torch.Tensor:
    """The keep-mask of a dropout at ``rate``: one uniform draw from
    ``gen`` per value, kept below ``1 - rate``. With a tuple of S
    generators, the seed-major rows are S blocks, each drawn from its own
    seed's generator."""
    if isinstance(gen, tuple):
        rows = (shape[0] // len(gen),) + tuple(shape[1:])
        return torch.cat([torch.rand(rows, generator=g, device=device) < 1.0 - rate
                          for g in gen])
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, training: bool,
            gen=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each value with probability ``1 - rate`` and
    scale the kept ones by ``1 / (1 - rate)``; the identity when not training
    or at rate 0. The mask is drawn from ``gen`` (on x's device), or taken
    from it when it is a ``DrawnMasks``."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = gen.take() if isinstance(gen, DrawnMasks) else keep_mask(x.shape, rate, gen,
                                                                     x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def seed_count(param: torch.Tensor, plain_dims: int) -> int:
    """S of a seed-stacked parameter (``plain_dims`` + 1 dimensions), 0 for
    a plain one."""
    return param.shape[0] if param.dim() == plain_dims + 1 else 0


def per_seed(x: torch.Tensor, s: int) -> torch.Tensor:
    """Seed-major rows (S·B, ...) as (S, B, ...)."""
    return x.reshape(s, -1, *x.shape[1:])


def seed_cat(a: torch.Tensor, b: torch.Tensor, s: int) -> torch.Tensor:
    """``torch.cat([a, b])`` within each seed: seed i's rows of ``a``, then
    its rows of ``b`` (``s`` 0 or 1: the plain concatenation)."""
    if s <= 1:
        return torch.cat([a, b], 0)
    return torch.cat([per_seed(a, s), per_seed(b, s)], 1).reshape(-1, *a.shape[1:])


def seed_head(x: torch.Tensor, s: int, rows: int) -> torch.Tensor:
    """``x[:rows]`` within each seed (``rows`` counts all seeds' rows)."""
    if s <= 1:
        return x[:rows]
    return per_seed(x, s)[:, :rows // s].reshape(-1, *x.shape[1:])


def seed_tail(x: torch.Tensor, s: int, rows: int) -> torch.Tensor:
    """``x[rows:]`` within each seed."""
    if s <= 1:
        return x[rows:]
    return per_seed(x, s)[:, rows // s:].reshape(-1, *x.shape[1:])


class SeedProduct(torch.autograd.Function):
    """Each seed's rows times its weight: (S, R, in) x (S, out, in) ->
    (S, R, out), plus each seed's (S, out) bias when one is given. The
    backward forms dW = gᵀ x straight in the weight's (S, out, in) layout
    and dX = g W, as ``F.linear``'s backward does for a plain weight, so a
    weight gradient has its parameter's strides (autograd's own backward of
    ``bmm(x, w.transpose(1, 2))`` leaves a transposed view, and AdamW's
    multi-tensor ops fall back to one launch per tensor on mixed strides)."""

    @staticmethod
    def forward(ctx, x3, w, bias):
        ctx.save_for_backward(x3, w)
        ctx.has_bias = bias is not None
        wt = w.transpose(1, 2)
        return torch.bmm(x3, wt) if bias is None else torch.baddbmm(bias[:, None, :], x3, wt)

    @staticmethod
    def backward(ctx, g):
        x3, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = torch.bmm(g, w) if need[0] else None
        dw = torch.bmm(g.transpose(1, 2), x3) if need[1] else None
        db = g.sum(1) if ctx.has_bias and need[2] else None
        return dx, dw, db


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, w)`` without bias; a seed-stacked (S, out, in) weight
    multiplies each seed's rows of x in one ``bmm`` (``SeedProduct``)."""
    if w.dim() == 2:
        return F.linear(x, w)
    y = SeedProduct.apply(x.reshape(w.shape[0], -1, x.shape[-1]), w, None)
    return y.reshape(*x.shape[:-1], w.shape[1])


def add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y + bias`` over the last axis; a seed-stacked (S, n) bias adds each
    seed's row to that seed's rows."""
    if bias.dim() == 1:
        return y + bias
    return (y.reshape(bias.shape[0], -1, y.shape[-1]) + bias[:, None, :]).reshape(y.shape)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, weight and bias cast to ``dtype``;
    the product is rounded to ``dtype`` before the bias is added."""
    y = matmul(x.to(dtype), layer.weight.to(dtype))
    if layer.bias is not None:
        y = add_bias(y, layer.bias.to(dtype))
    return y


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` (one rounding of product plus bias); a seed-stacked
    layer in one ``baddbmm`` (``SeedProduct``)."""
    w = layer.weight
    if w.dim() == 2:
        return layer(x)
    y = SeedProduct.apply(x.reshape(w.shape[0], -1, x.shape[-1]), w, layer.bias)
    return y.reshape(*x.shape[:-1], w.shape[1])


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: statistics and output in float32.
    Seed-stacked: one normalisation, then each seed's scale and bias."""
    if ln.weight.dim() == 1:
        return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                            ln.bias.float(), ln.eps)
    y = F.layer_norm(x.float(), ln.normalized_shape, None, None, ln.eps)
    s, h = ln.weight.shape
    return (y.reshape(s, -1, h) * ln.weight.float()[:, None, :]
            + ln.bias.float()[:, None, :]).reshape(y.shape)


def embed(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding``; a seed-stacked (S, V, E) table takes seed-major rows
    of ids, each read from its seed's table through the (S·V, E) view."""
    if weight.dim() == 2:
        return F.embedding(ids, weight)
    s, v, e = weight.shape
    rows = ids.shape[0]
    offset = (torch.arange(rows, device=ids.device) // (rows // s)) * v
    return F.embedding(ids + offset.view(-1, *([1] * (ids.dim() - 1))),
                       weight.reshape(s * v, e))


def embed_few(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``embed`` for a table of a few rows (the token types) as the product
    of the ids' one-hot rows and the table: the same values (exact in
    float32 without TF32, the port's policy), and a backward that is one
    matrix product. The gather's backward, on CUDA, sums the
    gradients of a row that every token of the batch reads (thousands of
    them) in no fixed order, so two runs of one step could differ."""
    if weight.dim() == 3:  # seed-stacked: each seed's rows of ids in its own table
        s, v, e = weight.shape
        rows = ids.shape[0]
        ids = ids + ((torch.arange(rows, device=ids.device) // (rows // s)) * v).view(
            -1, *([1] * (ids.dim() - 1)))
        weight = weight.reshape(s * v, e)
    hot = ids[..., None] == torch.arange(weight.shape[0], device=ids.device)
    return hot.to(weight.dtype) @ weight


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

            lins = (self.query, self.key, self.value, self.out)
            bias = [lin.bias.to(dt) for lin in lins]
            s = seed_count(self.query.weight, 2)

            def block(x, mask, ws, bs):
                # the transpose of a Linear weight is the flax (in, out)
                # layout, as a view; the backward's weight gradient is the
                # view of an (out, in) product, so the Linear's is that product
                ws = [m.transpose(-1, -2) for m in ws]
                return attn_block(x, mask, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2],
                                  ws[3], bs[3], heads=cfg.heads, impl=cfg.attn_impl)

            x = q_input.to(dt)
            if not s:
                out = block(x, key_mask, [lin.weight.to(dt) for lin in lins], bias)
            else:  # one block per seed, on its rows and its weights
                xs = per_seed(x, s)
                masks = [None] * s if key_mask is None else per_seed(key_mask, s)
                # unbind: one stack of the S gradients in the backward (S
                # selects would sum S zero-filled stacks), each seed's in
                # its (out, in) layout, so the stack has the parameter's
                ws = [lin.weight.to(dt).unbind(0) for lin in lins]
                bs = [t.unbind(0) for t in bias]
                out = torch.cat([block(xs[i], masks[i], [t[i] for t in ws], [t[i] for t in bs])
                                 for i in range(s)])
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


def _layer_with_masks(layer, x, key_mask, *masks):
    return layer(x, key_mask, DrawnMasks(masks))


class TransformerStack(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.layers))

    def forward(self, x, key_mask=None, gen=None):
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        rate = self.cfg.dropout
        for layer in self.layers:
            if not remat:
                x = layer(x, key_mask, gen)
                continue
            # the attention block's dropout, then the MLP's, both of x's shape
            masks = [keep_mask(x.shape, rate, gen, x.device) for _ in range(2)] if rate > 0 else []
            x = checkpoint(_layer_with_masks, layer, x, key_mask, *masks,
                           use_reentrant=False, preserve_rng_state=False)
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
    """Word + position + (optional) token-type embeddings, then LayerNorm.

    ``word_embeds`` (B, L, hidden), when given, takes the place of the word
    lookup (MMBT's joint sequence, embedded through a table of its own; the
    table's rows a lazy-AdamW step gathers, ``train/steps.py``); ``ids``
    then only gives the positions. A module built with
    ``word_table=False`` holds no word table, as the flax module that is
    only ever called so declares none."""

    def __init__(self, cfg: EncoderConfig, word_table: bool = True):
        super().__init__()
        self.cfg = cfg
        if word_table:
            self.word = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position = nn.Embedding(cfg.max_positions, cfg.hidden)
        self.token_type = (nn.Embedding(cfg.type_vocab, cfg.hidden)
                           if cfg.type_vocab else None)
        self.ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)

    def forward(self, ids, token_type_ids=None, gen=None, word_embeds=None):
        cfg = self.cfg
        dt = cfg.torch_dtype
        emb = (embed(ids, self.word.weight) if word_embeds is None else word_embeds).to(dt)
        if cfg.pos_offset:
            # RoBERTa family: positions count non-pad tokens, offset past the
            # pad id (the JAX package's formula, kept as it is)
            mask = (ids != cfg.pad_token_id).to(ids.dtype)
            pos_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        else:
            pos_ids = torch.arange(ids.shape[1], device=ids.device)[None, :]
            if seed_count(self.position.weight, 2):
                pos_ids = pos_ids.expand(ids.shape[0], -1)
        emb = emb + embed(pos_ids, self.position.weight).to(dt)
        if self.token_type is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(ids)
            emb = emb + embed_few(token_type_ids, self.token_type.weight).to(dt)
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

    def forward(self, ids, attention_mask=None, token_type_ids=None, gen=None,
                word_embeds=None):
        """``word_embeds`` (B, L, hidden), when given, replaces the word
        lookup (``TextEmbeddings``): the rows a lazy-AdamW step injects."""
        if attention_mask is None:
            attention_mask = torch.ones_like(ids)
        x = self.embeddings(ids, token_type_ids, gen, word_embeds)
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
        s = seed_count(p.weight, 4)
        if s:  # each seed's pixels through its own convolution, the call its own run makes
            pixels = per_seed(pixel_values.to(dt), s)
            weights = p.weight.to(dt).unbind(0)
            x = torch.cat([F.conv2d(pixels[i], weights[i], None, p.stride)
                           for i in range(s)])
        else:
            x = F.conv2d(pixel_values.to(dt), p.weight.to(dt), None, p.stride)
        # (B, patches, hidden), row-major
        x = add_bias(x.flatten(2).transpose(1, 2), p.bias.to(dt))
        k, h = max(s, 1), x.shape[-1]  # a plain model holds one seed
        prefix = self.prefix_tokens.to(dt).reshape(k, 1, -1, h).expand(k, b // k, -1, -1)
        x = torch.cat([prefix.reshape(b, -1, h), x], dim=1)
        x = x.reshape(k, b // k, -1, h) + self.pos_embed.to(dt).reshape(k, 1, -1, h)
        return dropout(x.reshape(b, -1, h), self.cfg.dropout, self.training, gen)


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
    0.02, ``prefix_tokens`` zero, and the constants a module sets in its own
    ``init_constants`` (BEiT's tables, tokens and layer scales, BatchNorm's
    scale and running statistics, the conv attention's gate), as flax
    initialises them. The JAX package draws other numbers from the same seed:
    tests carry weights across with ``models/from_jax.py``."""
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
            elif hasattr(m, "init_constants"):  # BEiT's, BatchNorm's, ... own constants
                m.init_constants()


def stack_seed_models(models) -> nn.Module:
    """S models of one architecture, each built as its own run builds it
    (its own init, its own pretrained imports), as one seed-stacked model:
    the first model with each parameter replaced by the ``torch.stack`` of
    the S models' along a new leading axis (``requires_grad`` kept). The
    models must hold no buffers."""
    base = models[0]
    names = [n for n, _ in base.named_parameters()]
    if set(base.state_dict()) != set(names):
        raise ValueError(f"{type(base).__name__} holds buffers; only parameters are stacked")
    params = [dict(m.named_parameters()) for m in models]
    if any(set(p) != set(names) for p in params):
        raise ValueError("the models to stack differ in their parameters")
    with torch.no_grad():
        for name in names:
            owner_name, _, leaf = name.rpartition(".")
            owner = base.get_submodule(owner_name)
            old = params[0][name]
            stacked = torch.stack([p[name].detach() for p in params])
            setattr(owner, leaf, nn.Parameter(stacked, requires_grad=old.requires_grad))
    return base


def params_for_seed(model: nn.Module, i: int) -> dict:
    """Seed ``i``'s slice of a seed-stacked model: the state dict its own
    run would hold, as compact CPU copies."""
    return {name: p.detach()[i].to("cpu", copy=True) for name, p in model.state_dict().items()}
