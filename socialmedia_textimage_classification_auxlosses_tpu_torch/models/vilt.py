"""ViLT early fusion: one pre-LN transformer over [text tokens ; image patches].

Counterpart of the JAX package's ``models/vilt.py``: ``interp_pos_grid``,
``ViltBackbone`` and ``ViltClassifier`` with the same parameter names, so
``models/from_jax.py`` carries a JAX tree across name by name. The heads are
the reference's: a linear classifier on dropout(CLS), ITC logits from the
normalised CLS and first image token of the joint sequence scaled by
``exp(logit_scale)``, and a TIM head on the CLS of a joint pass over swapped
texts.

Image preprocessing has two modes, as in the JAX package:

* default: every image resized to a fixed square (``image_size``), the whole
  grid attended;
* ``--vilt_exact_resize`` (``canvas_size`` set and ``grid_hw`` given): each
  image keeps its aspect on a fixed canvas (608 px, 19 x 19 patches), the
  learned 12 x 12 position grid is interpolated per sample to the image's
  true patch extent (bilinear, align-corners), and canvas patches past the
  extent are masked out of attention. With ViLT's 40 text tokens the joint
  sequence is 40 + 1 + 361 = 402 long.

Dtypes follow the flax modules: the text embeddings leave their LayerNorm in
float32, the patches are in the activation dtype, so the joint sequence (and
the pre-LN residual stream) is float32 and every dense layer computes in the
activation dtype; the heads run in float32. Dropout draws from the explicit
``torch.Generator`` handed down the forward (``gen``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .encoder import (EncoderConfig, Pooler, TextEmbeddings, TransformerStack, dense,
                      dropout, init_weights, layer_norm)


def interp_pos_grid(spatial: torch.Tensor, gh: torch.Tensor, gw: torch.Tensor,
                    out_side: int) -> torch.Tensor:
    """Bilinear align-corners interpolation of a learned ``(gs, gs, D)``
    position grid to each sample's true ``(gh, gw)`` patch extent, laid out
    on the ``(out_side, out_side)`` canvas grid (rows and columns past the
    extent are masked by the caller). ``gh``, ``gw``: (B,) integer tensors.
    Returns ``(B, out_side * out_side, D)`` in float32, the JAX formula
    evaluated per sample: ``F.interpolate(..., mode="bilinear",
    align_corners=True)`` over the extent."""
    gs = spatial.shape[0]
    spatial = spatial.float()
    yi = torch.arange(out_side, dtype=torch.float32, device=spatial.device)[None, :]

    def coords(g):
        s = yi * (gs - 1) / torch.clamp(g - 1, min=1).to(torch.float32)[:, None]
        s = torch.clamp(s, 0, gs - 1)
        lo = torch.floor(s).to(torch.long)
        return s, lo, torch.clamp(lo + 1, max=gs - 1)

    sy, y0, y1 = coords(gh)
    sx, x0, x1 = coords(gw)
    wy = (sy - y0)[:, :, None, None]
    wx = (sx - x0)[:, None, :, None]

    def at(y, x):  # (B, out, out, D): spatial[y[b, i], x[b, j]]
        return spatial[y[:, :, None], x[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return (top * (1 - wy) + bot * wy).reshape(gh.shape[0], out_side * out_side, -1)


class ViltBackbone(nn.Module):
    """Text embeddings + patch embeddings (+ modality types) -> pre-LN stack
    -> final LayerNorm -> pooler. Returns (hidden, pooled)."""

    def __init__(self, cfg: EncoderConfig, patch: int = 32, image_size: int = 384,
                 canvas_size: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.patch = patch
        self.image_size = image_size
        self.canvas_size = canvas_size
        self.base_side = image_size // patch
        h = cfg.hidden
        self.text_embeddings = TextEmbeddings(cfg)
        self.patch_proj = nn.Conv2d(3, h, patch, stride=patch)
        self.image_cls = nn.Parameter(torch.zeros(1, 1, h))
        self.image_pos = nn.Parameter(torch.zeros(1, 1 + self.base_side ** 2, h))
        self.modality_type = nn.Embedding(2, h)
        self.encoder = TransformerStack(cfg)
        self.ln_final = nn.LayerNorm(h, eps=cfg.ln_eps)
        self.pooler = Pooler(cfg)

    def forward(self, ids, attention_mask, token_type_ids, pixel_values,
                pixel_mask=None, grid_hw=None, gen=None):
        cfg = self.cfg
        dt = cfg.torch_dtype
        text = self.text_embeddings(ids, token_type_ids, gen)  # float32
        b = pixel_values.shape[0]
        if pixel_values.shape[1] != 3:
            pixel_values = pixel_values.permute(0, 3, 1, 2)  # NHWC -> NCHW
        p = self.patch_proj
        patches = F.conv2d(pixel_values.to(dt), p.weight.to(dt), None, p.stride)
        patches = (patches + p.bias.to(dt)[:, None, None]).flatten(2).transpose(1, 2)
        patches = torch.cat([self.image_cls.to(dt).expand(b, -1, -1), patches], dim=1)
        exact = self.canvas_size is not None and grid_hw is not None
        if exact:
            out_side = self.canvas_size // self.patch
            gh = torch.clamp(grid_hw[:, 0] // self.patch, min=1)
            gw = torch.clamp(grid_hw[:, 1] // self.patch, min=1)
            spatial = self.image_pos[0, 1:].float().reshape(self.base_side, self.base_side, -1)
            pos = torch.cat([self.image_pos[:, :1].float().expand(b, -1, -1),
                             interp_pos_grid(spatial, gh, gw, out_side)], dim=1)
            patches = patches + pos.to(dt)
            iy = torch.arange(out_side, device=grid_hw.device)
            grid_mask = ((iy[None, :, None] < gh[:, None, None])
                         & (iy[None, None, :] < gw[:, None, None]))
            img_mask = torch.cat([torch.ones(b, 1, dtype=torch.int32, device=grid_hw.device),
                                  grid_mask.reshape(b, -1).to(torch.int32)], dim=1)
        else:
            patches = patches + self.image_pos.to(dt)
            img_mask = (torch.ones(patches.shape[:2], dtype=torch.int32, device=patches.device)
                        if pixel_mask is None else pixel_mask.to(torch.int32))
        # modality types: 0 = text, 1 = image (flax Embed in the activation dtype)
        mod = self.modality_type.weight.to(dt)
        text = text + mod[0]
        patches = patches + mod[1]
        joint = torch.cat([text, patches.to(text.dtype)], dim=1)
        joint_mask = torch.cat([attention_mask.to(torch.int32), img_mask], dim=1)
        hidden = self.encoder(joint, joint_mask, gen)
        hidden = layer_norm(self.ln_final, hidden)
        return hidden, self.pooler(hidden)


class ViltClassifier(nn.Module):
    """The reference's ViLT head stack over ``ViltBackbone``.

    ``tim_batched`` (the default) runs the primary and the TIM joint passes
    as one 2B-row backbone call; each row still sees only its own (text,
    image) pair, so the math is the two-pass layout's (``tim_batched=False``,
    ``--tim_two_pass``), with dropout masks drawn once over 2B rows instead
    of twice over B."""

    def __init__(self, cfg: EncoderConfig, num_labels: int, patch: int = 32,
                 image_size: int = 384, dropout: float = 0.1,
                 logit_scale_init: float = 2.6592, tim_batched: bool = True,
                 canvas_size: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.dropout = dropout
        self.logit_scale_init = logit_scale_init
        self.tim_batched = tim_batched
        self.backbone = ViltBackbone(cfg, patch=patch, image_size=image_size,
                                     canvas_size=canvas_size)
        self.linear = nn.Linear(cfg.hidden, num_labels)
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale_init)))
        self.linear_tim = nn.Linear(cfg.hidden, 2)

    def forward(self, ids, attention_mask, token_type_ids, pixel_values,
                pixel_mask=None, grid_hw=None, tim_ids=None, tim_mask=None,
                tim_token_type_ids=None, gen=None):
        tim_hidden = None
        if tim_ids is not None and self.tim_batched:
            def cat(x, y):
                return torch.cat([x, y], 0)

            def two(x):
                return None if x is None else cat(x, x)

            hidden2, _ = self.backbone(
                cat(ids, tim_ids), cat(attention_mask, tim_mask),
                None if token_type_ids is None else cat(token_type_ids, tim_token_type_ids),
                two(pixel_values), two(pixel_mask), two(grid_hw), gen)
            b = ids.shape[0]
            hidden, tim_hidden = hidden2[:b], hidden2[b:]
        else:
            hidden, _ = self.backbone(ids, attention_mask, token_type_ids, pixel_values,
                                      pixel_mask, grid_hw, gen)
            if tim_ids is not None:
                tim_hidden, _ = self.backbone(tim_ids, tim_mask, tim_token_type_ids,
                                              pixel_values, pixel_mask, grid_hw, gen)
        cls = hidden[:, 0, :]
        out_cls = dense(self.linear, dropout(cls, self.dropout, self.training, gen).float(),
                        torch.float32)
        x_v = hidden[:, ids.shape[1], :]  # ITC split at the text-length boundary
        out_tim = None
        if tim_hidden is not None:
            out_tim = dense(self.linear_tim, tim_hidden[:, 0, :].float(), torch.float32)
        return {
            "out_cls": out_cls,
            "logits_per_text": self.logits_per_text(cls, x_v),
            "out_tim": out_tim,
            "out_iadds": None,
            "mm_features": cls,
        }

    def logits_per_text(self, x_t, x_v):
        """exp(logit_scale) times the cosines of the raw joint-sequence
        embeddings, as the reference (it declares projections it never
        applies; the JAX package and the port leave them out)."""
        t = x_t.float()
        v = x_v.float()
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return torch.exp(self.logit_scale) * (t @ v.t())


def init_vilt_weights(model: ViltClassifier, generator: torch.Generator) -> None:
    """Random init from ``generator`` after the flax initializers:
    ``init_weights`` for the dense, conv, embedding and LayerNorm layers,
    ``image_pos`` normal 0.02, ``image_cls`` zero and ``logit_scale`` at its
    initial value."""
    init_weights(model, generator)
    with torch.no_grad():
        model.backbone.image_pos.normal_(0.0, 0.02, generator=generator)
        model.backbone.image_cls.zero_()
        model.logit_scale.fill_(model.logit_scale_init)
