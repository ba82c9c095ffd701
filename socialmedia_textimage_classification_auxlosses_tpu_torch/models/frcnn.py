"""Faster R-CNN object features for LXMERT (inference), in PyTorch.

Counterpart of the JAX package's ``models/frcnn.py``: the Visual Genome
detector family of ``unc-nlp/frcnn-vg-finetuned`` that the reference runs
outside its repo (reference ``models/obj_features.py:142-173``),

    Caffe ResNet-C4 trunk (the stride on the first 1x1, frozen batch norm)
    -> RPN over res4 (anchors 32..512 x ratios 0.5 / 1 / 2, stride 16)
    -> greedy NMS -> res5 over ROIAlign-pooled proposals
    -> class scores + class-specific boxes -> per-class NMS
    -> ``max_detections`` (36) regions: ``roi_features`` (36, 2048) and
       ``normalized_boxes`` (36, 4), x0, y0, x1, y1 in [0, 1] of the resized
       image.

The modules are NCHW ``nn.Module``s named in the published Detectron2 layout
(``backbone.stem.conv1``, ``backbone.res{2..4}.{i}.conv{1,2,3}[.norm]``,
``shortcut``, ``proposal_generator.rpn_head.*``, ``roi_heads.res5.{i}``,
``roi_heads.box_predictor.*``), so a checkpoint of that layout loads with a
strict ``load_state_dict`` (``load_frcnn``; ``models/from_jax.py::
frcnn_state_from_jax`` carries the JAX detector's tree). The convolutions are
``F.conv2d`` (cuDNN on the card), as in the ResNet towers: the JAX package
leaves them, its einsums and its ``while_loop``s to XLA, not to a Pallas
kernel. The dtype flow is flax's: with ``cfg.dtype = "bfloat16"`` the trunk's
and res5's convolutions compute in bfloat16, the RPN's logits and deltas come
out in float32, ROIAlign promotes to float32 and res5's mean-pooled features
are float32.

Two ways through, as in the JAX package:

* ``detect_batch(fused=False)``, the staged path: the trunk and RPN head on the
  device, the RPN's top-k and exact greedy NMS on the host (``greedy_nms``;
  the box decode on the device, with the fused path's arithmetic, so that both
  paths decide on the same bits), ROIAlign + res5 + the heads on the device
  over a fixed proposal count, the per-class NMS and the final selection on
  the host, and a device gather of only the chosen feature rows;
* the fused path (default): the RPN and the per-class NMS on the device
  (``nms_keep_device``, a blocked greedy scan over boxes sorted by score, with
  all the images of a window in lockstep, one host read of a flag per block
  step for the whole window), only the 36 regions copied to the host. The
  path calls the scan as the ``torch.library`` op ``smtc::nms_keep``
  (``nms_keep``), whose implementation is ``nms_keep_device`` itself and
  whose fake gives the output shapes, so ``torch.export`` records the scan as
  one node and the rest of the path around it (``FusedDetectProgram``,
  ``cli/export.py --export_detector``); under export stage 2's per-image
  pass is recorded once and mapped over the batch (``torch``'s ``map``
  higher-order op), where the live path loops.
  ``prepare_batch`` (numpy and PIL only) and ``detect_prepared_async``
  split the host's work from the card's, so that the offline cacher
  prepares its next chunk in a thread while the card works on this one; a
  torch ``while`` test is a host read, so the dispatch itself waits for
  stage 1 and the RPN.

Stage 2 runs ROIAlign and res5 over one image's proposals at a time, in
chunks of ``roi_chunk`` ROIs, so its peak memory does not grow with the
batch (a full window of 16 x 1,000 pooled 1,024 x 14 x 14 float32 inputs
would be 12.8 GB). ``ingest="device"`` ships the original uint8 pixels and
resizes them on the device with ``F.interpolate(bilinear,
align_corners=False)`` (the float branch of the reference's transform family;
``preprocess_image`` is the PIL branch, the parity default). ``pad_to`` is
accepted where the JAX package takes it; nothing is padded, since torch
compiles nothing per shape and a padded row changes no result.

Without weights the detector is random, drawn from an explicit
``torch.Generator`` after flax's initializers (truncated lecun-normal
kernels, zero biases, frozen batch norm at identity). PIL is imported only
where an image is resized on the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class FrcnnConfig:
    """Geometry/thresholds of the VG detector (values as published for
    unc-nlp/frcnn-vg-finetuned; shrink for tests)."""

    stem_features: int = 64
    stage_sizes: Tuple[int, ...] = (3, 4, 23)   # res2..res4 (R101-C4)
    res5_blocks: int = 3
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    stride: int = 16                            # res4 stride
    rpn_pre_nms_topk: int = 6000
    rpn_post_nms_topk: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_min_box_size: float = 0.0
    box_score_thresh: float = 0.2
    box_nms_thresh: float = 0.5
    max_detections: int = 36
    min_detections: int = 36
    num_classes: int = 1600                     # VG objects (bg column last)
    feat_dim: int = 2048
    pooler_resolution: int = 14
    sampling_ratio: int = 2
    rpn_bbox_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    box_bbox_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    pixel_mean_bgr: Tuple[float, ...] = (102.9801, 115.9465, 122.7754)
    min_size: int = 800
    max_size: int = 1333
    size_divisibility: int = 32
    dtype: str = "float32"

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes) * len(self.anchor_ratios)

    @property
    def res4_features(self) -> int:
        # stem -> 4*stem after res2, doubling per stage
        return self.stem_features * 4 * (2 ** (len(self.stage_sizes) - 1))


TINY = FrcnnConfig(
    stem_features=8, stage_sizes=(1, 1, 1), res5_blocks=1,
    anchor_sizes=(16, 32), anchor_ratios=(1.0,), rpn_pre_nms_topk=64,
    rpn_post_nms_topk=16, max_detections=5, min_detections=5, num_classes=7,
    feat_dim=64, pooler_resolution=4, min_size=64, max_size=96,
    box_score_thresh=0.0,
    # damped decoded shifts keep the proposals of a random detector on the
    # canvas (an untrained deltas head emits +-50-100; at weights (1, ..)
    # every box decodes off-canvas and the detector rightly returns no
    # region)
    rpn_bbox_weights=(25.0, 25.0, 12.5, 12.5),
)


def apply_topk_overrides(cfg: "FrcnnConfig", pre_topk=None, post_topk=None):
    """RPN proposal-budget knobs (``--rpn_pre_topk``/``--rpn_post_topk``).

    ``pre_topk`` caps the score-ordered anchor set entering RPN NMS;
    ``post_topk`` caps the ROI count fed to res5, the per-ROI stage that
    dominates the device time at full geometry. Both default to the
    published values (6000/1000); a reduction trades recall for speed and is
    logged loudly, so that cached features are never built from a pruned
    proposal set unnoticed."""
    if pre_topk is None and post_topk is None:
        return cfg
    kw = {}
    if pre_topk is not None:
        if pre_topk < 1:
            raise ValueError(f"rpn_pre_topk must be >= 1, got {pre_topk}")
        kw["rpn_pre_nms_topk"] = int(pre_topk)
    if post_topk is not None:
        if post_topk < cfg.max_detections:
            raise ValueError(
                f"rpn_post_topk {post_topk} < max_detections "
                f"{cfg.max_detections}: the final selection needs at least "
                "that many candidate ROIs")
        kw["rpn_post_nms_topk"] = int(post_topk)
    # the post-NMS budget never exceeds the pre-NMS candidate set (the fused
    # path sizes its proposal tensor to post and fills it from the pre-topk
    # survivors)
    pre_eff = kw.get("rpn_pre_nms_topk", cfg.rpn_pre_nms_topk)
    post_eff = min(kw.get("rpn_post_nms_topk", cfg.rpn_post_nms_topk), pre_eff)
    if post_eff < cfg.max_detections:
        raise ValueError(
            f"effective rpn_post_topk {post_eff} < max_detections "
            f"{cfg.max_detections}: the final selection needs at least "
            "that many candidate ROIs")
    kw["rpn_post_nms_topk"] = post_eff
    new = dataclasses.replace(cfg, **kw)
    if (new.rpn_pre_nms_topk < cfg.rpn_pre_nms_topk
            or new.rpn_post_nms_topk < cfg.rpn_post_nms_topk):
        logger.warning(
            "FRCNN RPN budget reduced: pre-NMS %d->%d, post-NMS %d->%d — "
            "faster, but a recall trade vs the published detector; "
            "validate on real weights before trusting cached features",
            cfg.rpn_pre_nms_topk, new.rpn_pre_nms_topk,
            cfg.rpn_post_nms_topk, new.rpn_post_nms_topk)
    return new


# ---------------------------------------------------------------------------
# Modules (NCHW, Detectron2 names)
# ---------------------------------------------------------------------------


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: ``t`` itself where it is in ``dtype`` already, as
    ``Tensor.to`` returns it, but without the cast nodes that ``torch.export``
    would record for each convolution's input and weight and each frozen
    batch norm's scale and shift (the exported detector's size and its save
    and load times)."""
    return t if t.dtype == dtype else t.to(dtype)


def _channels(t: torch.Tensor) -> torch.Tensor:
    """A per-channel (C,) vector as (C, 1, 1), to broadcast over (..., C, H, W)."""
    return t.view(-1, 1, 1)


class FrozenBN(nn.Module):
    """Inference-frozen batch norm: Detectron2's four buffers, never trained.
    ``x * scale + shift`` with scale and shift formed in float32 and cast to
    the activation's dtype, as the flax module does."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def init_constants(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * _channels(_cast(scale, x.dtype)) + _channels(_cast(shift, x.dtype))


class Conv(nn.Conv2d):
    """Detectron2's ``Conv2d``: a convolution with an optional bias and an
    optional ``norm`` child, computed in ``dtype`` (input, kernel and bias
    cast to it, the bias added after the convolution, as flax's ``Conv``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = False, norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=padding, bias=bias)
        self.norm = FrozenBN(cout) if norm else None
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(_cast(x, dt), _cast(self.weight, dt), None, self.stride, self.padding)
        if self.bias is not None:
            y = y + _channels(_cast(self.bias, dt))
        return self.norm(y) if self.norm is not None else y


class CaffeBottleneck(nn.Module):
    """Detectron ``BottleneckBlock`` with ``stride_in_1x1=True`` (the Caffe
    ResNet quirk: the stage stride sits on the FIRST 1x1 conv)."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, width, 1, stride=stride, dtype=dtype)
        self.conv2 = Conv(width, width, 3, padding=1, dtype=dtype)
        self.conv3 = Conv(width, width * 4, 1, dtype=dtype)
        self.shortcut = (Conv(cin, width * 4, 1, stride=stride, dtype=dtype)
                         if cin != width * 4 or stride != 1 else None)

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        s = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(y + s)


class Stem(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(3, features, 7, stride=2, padding=3, dtype=dtype)

    def forward(self, x):
        # Caffe's max-pool: 3x3 / 2 padded (0, 1) with -inf on each axis,
        # which is the ceil-mode pool (tests/test_torch_frcnn.py)
        return F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, ceil_mode=True)


def _dtype(cfg: FrcnnConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class C4Backbone(nn.Module):
    """Stem + res2..res4 -> the stride-16 feature map the RPN and the ROI
    head share (C4 detectors have no FPN)."""

    def __init__(self, cfg: FrcnnConfig):
        super().__init__()
        dt = _dtype(cfg)
        self.stem = Stem(cfg.stem_features, dt)
        cin = cfg.stem_features
        self.stages = []
        for stage, blocks in enumerate(cfg.stage_sizes):
            width = cfg.stem_features * (2 ** stage)
            seq = nn.Sequential()
            for b in range(blocks):
                seq.add_module(str(b), CaffeBottleneck(
                    cin, width, stride=2 if stage > 0 and b == 0 else 1, dtype=dt))
                cin = width * 4
            self.add_module(f"res{stage + 2}", seq)
            self.stages.append(f"res{stage + 2}")
        self.compute_dtype = dt

    def forward(self, x):  # (B, 3, H, W) BGR, mean-subtracted, float32
        x = self.stem(_cast(x, self.compute_dtype))
        for name in self.stages:
            x = getattr(self, name)(x)
        return x


class RpnHead(nn.Module):
    """A 3x3 conv in the trunk's dtype, then the objectness logits and anchor
    deltas as float32 1x1 convs."""

    def __init__(self, cfg: FrcnnConfig):
        super().__init__()
        c, a = cfg.res4_features, cfg.num_anchors
        self.conv = Conv(c, c, 3, padding=1, bias=True, norm=False, dtype=_dtype(cfg))
        self.objectness_logits = Conv(c, a, 1, bias=True, norm=False)
        self.anchor_deltas = Conv(c, 4 * a, 1, bias=True, norm=False)

    def forward(self, fmap):
        t = F.relu(self.conv(fmap))
        return self.objectness_logits(t), self.anchor_deltas(t)


class ProposalGenerator(nn.Module):
    def __init__(self, cfg: FrcnnConfig):
        super().__init__()
        self.rpn_head = RpnHead(cfg)


class Res5Head(nn.Sequential):
    """The res5 stage applied per ROI (Detectron ``Res5ROIHeads``): pooled
    (P, P) windows -> (P/2, P/2) -> mean pool -> ``feat_dim`` float32
    features."""

    def __init__(self, cfg: FrcnnConfig):
        width = cfg.feat_dim // 4
        dt = _dtype(cfg)
        super().__init__(*[CaffeBottleneck(cfg.res4_features if b == 0 else width * 4, width,
                                           stride=2 if b == 0 else 1, dtype=dt)
                           for b in range(cfg.res5_blocks)])

    def forward(self, rois):  # (N, C4, P, P)
        return _cast(super().forward(rois).mean(dim=(2, 3)), torch.float32)


class BoxPredictor(nn.Module):
    """cls_score (num_classes + background-last) + class-specific box
    regression over the pooled res5 feature, in float32."""

    def __init__(self, cfg: FrcnnConfig):
        super().__init__()
        self.cls_score = nn.Linear(cfg.feat_dim, cfg.num_classes + 1)
        self.bbox_pred = nn.Linear(cfg.feat_dim, cfg.num_classes * 4)

    def forward(self, feats):
        return self.cls_score(feats), self.bbox_pred(feats)


class RoiHeads(nn.Module):
    def __init__(self, cfg: FrcnnConfig):
        super().__init__()
        self.res5 = Res5Head(cfg)
        self.box_predictor = BoxPredictor(cfg)


class FrcnnStage1(nn.Module):
    """Trunk + RPN head (everything dense before proposal selection).

    Input is the padded canvas, (B, Hp, Wp, 3) RGB, uint8 (the PIL path) or
    float32 (device ingest); the BGR flip and the pixel-mean subtraction run
    on the device and the pad region is re-zeroed from ``size_hw``
    (Detectron's pad-after-normalize: zeros in normalized space, not
    -mean). Returns the res4 map (B, C4, H/16, W/16) in the trunk's dtype and
    the float32 logits (B, A, ...) and deltas (B, 4A, ...)."""

    def __init__(self, cfg: FrcnnConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = C4Backbone(cfg)
        self.proposal_generator = ProposalGenerator(cfg)

    def forward(self, images, size_hw):
        dev = images.device
        mean = torch.tensor(self.cfg.pixel_mean_bgr, dtype=torch.float32, device=dev)
        x = images.float().flip(-1) - mean
        ph, pw = images.shape[1], images.shape[2]
        row = torch.arange(ph, dtype=torch.float32, device=dev)[None, :, None]
        col = torch.arange(pw, dtype=torch.float32, device=dev)[None, None, :]
        inside = (row < size_hw[:, 0, None, None]) & (col < size_hw[:, 1, None, None])
        x = torch.where(inside[..., None], x, torch.zeros((), device=dev))
        fmap = self.backbone(x.permute(0, 3, 1, 2).contiguous())
        logits, deltas = self.proposal_generator.rpn_head(fmap)
        return fmap, logits, deltas


class FrcnnStage2(nn.Module):
    """ROIAlign + res5 + the output heads over a fixed proposal count,
    (B, N, 4) boxes per image. Class selection and box decode run on the
    device: only (feats, best prob, best class, decoded boxes) leave it.
    ROIAlign and res5 go through one image's ROIs ``roi_chunk`` at a time."""

    def __init__(self, cfg: FrcnnConfig, roi_chunk: int = 256):
        super().__init__()
        self.cfg = cfg
        self.roi_chunk = roi_chunk
        self.roi_heads = RoiHeads(cfg)

    def pooled_features(self, fmap, boxes):
        """(C, H, W) map and (N, 4) boxes of one image -> (N, feat_dim)
        float32 res5 features, chunk by chunk."""
        cfg = self.cfg
        out = []
        for s in range(0, boxes.shape[0], self.roi_chunk):
            bx = boxes[s:s + self.roi_chunk]
            pooled = roi_align(fmap, bx, output_size=cfg.pooler_resolution,
                               spatial_scale=1.0 / cfg.stride,
                               sampling_ratio=cfg.sampling_ratio, chunk=bx.shape[0])
            out.append(self.roi_heads.res5(pooled))
        return torch.cat(out) if out else fmap.new_zeros((0, cfg.feat_dim), dtype=torch.float32)

    def forward(self, fmap, boxes, size_hw):
        cfg = self.cfg
        b, n = boxes.shape[:2]
        if torch.compiler.is_exporting():
            # one traced copy of the per-image pass, mapped over the batch: the loop
            # below, unrolled, would put B copies of it in the program (the same
            # operations on the same slices either way)
            from torch._higher_order_ops.map import map as map_images

            feats = map_images(lambda pair: self.pooled_features(*pair), (fmap, boxes))
        else:
            feats = torch.stack([self.pooled_features(fmap[i], boxes[i]) for i in range(b)])
        scores, deltas = self.roi_heads.box_predictor(feats)
        probs = torch.softmax(scores, dim=-1)[..., :-1]   # background LAST
        best, cls = probs.max(dim=-1)
        dsel = torch.gather(deltas.reshape(b, n, cfg.num_classes, 4), 2,
                            cls[:, :, None, None].expand(b, n, 1, 4))[:, :, 0]
        det = decode_boxes(boxes, dsel, cfg.box_bbox_weights)
        det = clip_boxes(det, size_hw[:, 0, None], size_hw[:, 1, None])
        return feats, best, cls, det


# ---------------------------------------------------------------------------
# Pure geometry (shared by device stages and host selection)
# ---------------------------------------------------------------------------


def generate_anchors(cfg: FrcnnConfig, grid_h: int, grid_w: int) -> np.ndarray:
    """(grid_h * grid_w * A, 4) anchors in x0,y0,x1,y1 image coordinates,
    centered on stride-spaced grid points (Detectron2 zero-offset
    convention), ordered cell-major then anchor."""
    base = []
    for size in cfg.anchor_sizes:
        area = float(size) ** 2
        for ratio in cfg.anchor_ratios:
            w = math.sqrt(area / ratio)
            h = w * ratio
            base.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    base = np.asarray(base, np.float32)                      # (A, 4)
    shifts_x = np.arange(grid_w, dtype=np.float32) * cfg.stride
    shifts_y = np.arange(grid_h, dtype=np.float32) * cfg.stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)                 # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_boxes(anchors, deltas, weights, scale_clamp=math.log(1000.0 / 16)):
    """Detectron box transform: anchors + (dx,dy,dw,dh)/weights -> boxes
    (torch tensors, any leading shape)."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=scale_clamp)
    dh = torch.clamp(deltas[..., 3] / wh, max=scale_clamp)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes, height, width):
    """Clamp x to [0, width] and y to [0, height] (numbers or tensors that
    broadcast against ``boxes[..., 0]``)."""
    def clip(v, hi):
        v = torch.clamp(v, min=0)
        return torch.minimum(v, hi) if isinstance(hi, torch.Tensor) else torch.clamp(v, max=hi)

    return torch.stack([clip(boxes[..., 0], width), clip(boxes[..., 1], height),
                        clip(boxes[..., 2], width), clip(boxes[..., 3], height)], dim=-1)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float,
               max_out: Optional[int] = None) -> np.ndarray:
    """Exact sequential NMS (torchvision semantics: IoU strictly greater
    than ``thresh`` suppresses). Host numpy."""
    order = np.argsort(-scores, kind="stable")
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if max_out is not None and len(keep) >= max_out:
            break
        rest = order[1:]
        xx0 = np.maximum(x0[i], x0[rest])
        yy0 = np.maximum(y0[i], y0[rest])
        xx1 = np.minimum(x1[i], x1[rest])
        yy1 = np.minimum(y1[i], y1[rest])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        union = areas[i] + areas[rest] - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        order = rest[iou <= thresh]
    return np.asarray(keep, np.int64)


def _pairwise_iou(boxes_a, boxes_b):
    """(..., A, 4) x (..., B, 4) -> (..., A, B) IoU (xyxy; degenerate boxes
    -> 0)."""
    ax0, ay0, ax1, ay1 = boxes_a.unbind(-1)
    bx0, by0, bx1, by1 = boxes_b.unbind(-1)
    area_a = torch.clamp(ax1 - ax0, min=0) * torch.clamp(ay1 - ay0, min=0)
    area_b = torch.clamp(bx1 - bx0, min=0) * torch.clamp(by1 - by0, min=0)
    xx0 = torch.maximum(ax0[..., :, None], bx0[..., None, :])
    yy0 = torch.maximum(ay0[..., :, None], by0[..., None, :])
    xx1 = torch.minimum(ax1[..., :, None], bx1[..., None, :])
    yy1 = torch.minimum(ay1[..., :, None], by1[..., None, :])
    inter = torch.clamp(xx1 - xx0, min=0) * torch.clamp(yy1 - yy0, min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


def nms_keep_device(boxes, alive, thresh: float, max_out: int, group=None,
                    block: int = 64):
    """Exact greedy NMS on the device over boxes ALREADY SORTED by score
    descending (dead rows sorted to the back), for one image ((N, 4) boxes,
    (N,) alive) or a window of images in lockstep ((B, N, 4), (B, N)), as the
    JAX function under ``vmap``. Semantics identical to ``greedy_nms``: a
    kept box suppresses every later box with IoU strictly greater than
    ``thresh``; an image's scan stops once ``max_out`` boxes are kept (later
    rows keep their current flag: callers compact in score order and cut at
    ``max_out``, so an uninspected tail row never surfaces).

    ``group`` (optional int tensor like ``alive``) restricts suppression to
    same-group boxes: one scan over the global score order is then exactly
    the independent per-group greedy scans (the device form of the staged
    path's per-class NMS loop, with no coordinate offsetting).

    Blocked: ``block`` rows per step. A step resolves exact greedy WITHIN the
    block by the self-suppression fixpoint (``kb <- entry & ~any(j < i:
    kb[j] & iou > t)`` until stable, the greedy recurrence's unique
    solution), then suppresses every later row against the block's kept
    boxes in one (block x N) product. Each loop test is one host read for
    the whole window: one a step, one a fixpoint round. The early stop
    quantises to block boundaries; the first ``max_out`` kept rows in order
    match the row-at-a-time scan exactly. Returns ``(keep mask, kept count
    clamped to max_out)``."""
    single = alive.dim() == 1
    if single:
        boxes, alive = boxes[None], alive[None]
        group = None if group is None else group[None]
    bsz, n = alive.shape
    dev = alive.device
    if n == 0:
        keep, cnt = torch.zeros((bsz, 0), dtype=torch.bool, device=dev), torch.zeros(
            bsz, dtype=torch.int64, device=dev)
        return (keep[0], cnt[0]) if single else (keep, cnt)
    b = min(block, n)
    pad = (-n) % b
    nb = (n + pad) // b
    boxes_p = F.pad(boxes, (0, 0, 0, pad))
    keep = F.pad(alive, (0, pad))
    group_p = None if group is None else F.pad(group, (0, pad), value=-1)
    nlive = alive.sum(dim=1)
    tri = torch.triu(torch.ones((b, b), dtype=torch.bool, device=dev), diagonal=1)
    rows_all = torch.arange(n + pad, device=dev)
    cnt = torch.zeros(bsz, dtype=torch.int64, device=dev)
    active = (cnt < max_out) & (nlive > 0)
    blk = 0
    while blk < nb and bool(active.any()):
        start = blk * b
        blk_boxes = boxes_p[:, start:start + b]
        entry = keep[:, start:start + b]
        sup_bn = _pairwise_iou(blk_boxes, boxes_p) > thresh          # (B, b, N)
        if group_p is not None:
            sup_bn = sup_bn & (group_p[:, start:start + b, None] == group_p[:, None, :])
        sup_bb = sup_bn[:, :, start:start + b] & tri
        kb = entry
        while True:
            kb2 = entry & ~(sup_bb & kb[:, :, None]).any(dim=1)
            if torch.equal(kb2, kb):
                break
            kb = kb2
        sup_later = (sup_bn & kb[:, :, None]).any(dim=1) & (rows_all >= start + b)
        stepped = keep.clone()
        stepped[:, start:start + b] = kb
        stepped &= ~sup_later
        keep = torch.where(active[:, None], stepped, keep)
        cnt = cnt + torch.where(active, kb.sum(dim=1), 0)
        blk += 1
        active = (cnt < max_out) & (blk * b < nlive)
    keep, cnt = keep[:, :n], torch.clamp(cnt, max=max_out)
    return (keep[0], cnt[0]) if single else (keep, cnt)


@torch.library.custom_op("smtc::nms_keep", mutates_args=())
def nms_keep(boxes: torch.Tensor, alive: torch.Tensor, thresh: float, max_out: int,
             group: Optional[torch.Tensor] = None, block: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_keep_device`` as the ``torch.library`` op ``smtc::nms_keep``, on
    every device: the node ``torch.export`` records for the scan, whose host
    reads a traced program cannot hold. Its results are
    ``nms_keep_device``'s, bit for bit."""
    return nms_keep_device(boxes, alive, thresh, max_out, group, block)


@nms_keep.register_fake
def _nms_keep_fake(boxes, alive, thresh, max_out, group=None, block=64):
    return (torch.empty_like(alive, dtype=torch.bool),
            alive.new_empty(alive.shape[:-1], dtype=torch.int64))


def _roi_sample_coords(bx, p, s, spatial_scale):
    """Per-ROI bilinear sample coordinates (torchvision aligned=False legacy
    semantics, fixed ``sampling_ratio``): (ys, xs), each (n, P, S). The grid
    is a Cartesian product, which lets the sample average factor into
    separable per-axis interpolation matrices."""
    x0 = bx[:, 0] * spatial_scale
    y0 = bx[:, 1] * spatial_scale
    x1 = bx[:, 2] * spatial_scale
    y1 = bx[:, 3] * spatial_scale
    roi_w = torch.clamp(x1 - x0, min=1.0)
    roi_h = torch.clamp(y1 - y0, min=1.0)
    # sample positions: start + (bin + (i+0.5)/S) * bin_size
    dev = bx.device
    grid = (torch.arange(p, device=dev)[:, None]
            + (torch.arange(s, device=dev)[None] + 0.5) / s)
    ys = y0[:, None, None] + grid[None] * (roi_h / p)[:, None, None]
    xs = x0[:, None, None] + grid[None] * (roi_w / p)[:, None, None]
    return ys, xs


def _interp_axis(coord, size):
    # torchvision semantics: samples below -1 or beyond size contribute 0;
    # in-range coords clamp to [0, size-1]
    valid = (coord >= -1.0) & (coord <= size)
    c = torch.clamp(coord, 0.0, size - 1.0)
    i0 = torch.floor(c).long()
    i1 = torch.clamp(i0 + 1, max=size - 1)
    frac = c - i0
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    return i0, i1, torch.where(valid, 1.0 - frac, zero), torch.where(valid, frac, zero)


def _interp_matrix(coord, size, s):
    """(n, P, S) sample coordinates -> (n, P, size) interpolation matrix:
    row (n, p) holds the two bilinear taps of each of the S samples, scaled
    1/S. Built from one-hot rows, so coincident taps (clamped edges) sum."""
    i0, i1, w0, w1 = _interp_axis(coord, size)
    oh0 = F.one_hot(i0, size).to(w0.dtype)                   # (n,P,S,size)
    oh1 = F.one_hot(i1, size).to(w0.dtype)
    return (torch.einsum("nps,npsh->nph", w0 / s, oh0)
            + torch.einsum("nps,npsh->nph", w1 / s, oh1))


def roi_align(fmap, boxes, *, output_size: int, spatial_scale: float,
              sampling_ratio: int, chunk: int = 32, impl: str = "mm"):
    """ROIAlign, aligned=False legacy coordinates (torchvision/Detectron
    semantics at fixed ``sampling_ratio``): bilinear samples averaged per
    output bin, in float32. ``fmap``: (C, H, W); ``boxes``: (N, 4) x0, y0,
    x1, y1 in image coordinates; returns (N, C, P, P), ``chunk`` ROIs at a
    time.

    ``impl="mm"`` (default): two interpolation products per chunk,
    out[n, c] = Ky[n] @ fmap[c] @ Kx[n]^T, the per-bin sample average folded
    into Ky / Kx (the sample grid is a Cartesian product, so this is the
    sampled average up to float32 summation order). ``impl="gather"``
    gathers the four corners of every sample instead."""
    fmap = _cast(fmap, torch.float32)
    c, h, w = fmap.shape
    p = output_size
    s = sampling_ratio

    def pool_chunk_mm(bx):
        ys, xs = _roi_sample_coords(bx, p, s, spatial_scale)
        ky = _interp_matrix(ys, h, s)                        # (n,P,H)
        kx = _interp_matrix(xs, w, s)                        # (n,P,W)
        tmp = torch.einsum("nph,chw->ncpw", ky, fmap)        # (n,C,P,W)
        return torch.einsum("nqw,ncpw->ncpq", kx, tmp)       # (n,C,P,P)

    def pool_chunk_gather(bx):
        ys, xs = _roi_sample_coords(bx, p, s, spatial_scale)
        yi0, yi1, wy0, wy1 = _interp_axis(ys, h)             # (n,P,S)
        xi0, xi1, wx0, wx1 = _interp_axis(xs, w)
        flat = fmap.reshape(c, h * w)

        def gather(yy, xx):                                  # -> (C,n,P,S,P,S)
            idx = yy[:, :, :, None, None] * w + xx[:, None, None, :, :]
            return flat[:, idx.reshape(-1)].reshape((c,) + idx.shape)

        def wgt(a, b):
            return a[:, :, :, None, None] * b[:, None, None, :, :]

        val = (gather(yi0, xi0) * wgt(wy0, wx0) + gather(yi0, xi1) * wgt(wy0, wx1)
               + gather(yi1, xi0) * wgt(wy1, wx0) + gather(yi1, xi1) * wgt(wy1, wx1))
        return val.mean(dim=(3, 5)).permute(1, 0, 2, 3)      # (n,C,P,P)

    pool_chunk = pool_chunk_mm if impl == "mm" else pool_chunk_gather
    boxes = _cast(boxes, torch.float32)
    if boxes.shape[0] == 0:
        return fmap.new_zeros((0, c, p, p))
    return torch.cat([pool_chunk(boxes[i:i + chunk]) for i in range(0, boxes.shape[0], chunk)])


# ---------------------------------------------------------------------------
# Preprocessing (reference Preprocess: image_processing.py:18-37)
# ---------------------------------------------------------------------------


def preprocess_geometry(h0: int, w0: int, cfg: FrcnnConfig):
    """Resize geometry shared by every ingest path: -> (h1, w1, ph, pw).

    Shortest side to ``min_size`` capped so the longest stays <=
    ``max_size``; one canvas per orientation, (min, max) landscape / (max,
    min) portrait, rounded up to the stride divisor."""
    scale = cfg.min_size / min(h0, w0)
    if max(h0, w0) * scale > cfg.max_size:
        scale = cfg.max_size / max(h0, w0)
    h1 = max(int(round(h0 * scale)), 1)
    w1 = max(int(round(w0 * scale)), 1)
    div = cfg.size_divisibility

    def rup(v):
        return ((v + div - 1) // div) * div

    ph = rup(cfg.min_size) if w1 >= h1 else rup(cfg.max_size)
    pw = rup(cfg.max_size) if w1 >= h1 else rup(cfg.min_size)
    return h1, w1, ph, pw


def _to_rgb_array(img) -> np.ndarray:
    """A PIL image or an (H, W, 3) uint8 array as an RGB uint8 array (PIL
    only touched when the image is one)."""
    if isinstance(img, np.ndarray):
        return img
    return np.asarray(img.convert("RGB"))


def preprocess_image(img, cfg: FrcnnConfig):
    """RGB uint8 array or PIL image -> (padded RAW uint8 RGB canvas
    (Hp, Wp, 3), (resized_h, resized_w), scale_yx original/resized).

    The PIL-bilinear host resize, the parity path: the reference's detector
    preprocessing takes the uint8 branch, which resizes with
    ``PIL.Image.resize(BILINEAR)``. The BGR flip and the mean subtraction
    run on the device in ``FrcnnStage1``; ``normalize_canvas`` reproduces
    them on the host."""
    from PIL import Image

    arr = _to_rgb_array(img)
    h0, w0 = arr.shape[:2]
    h1, w1, ph, pw = preprocess_geometry(h0, w0, cfg)
    resized = np.asarray(Image.fromarray(arr).resize((w1, h1), Image.BILINEAR), np.uint8)
    out = np.zeros((ph, pw, 3), np.uint8)
    out[:h1, :w1] = resized
    scale_yx = np.asarray([h0 / h1, w0 / w1], np.float32)
    return out, (h1, w1), scale_yx


def preprocess_image_original(img, cfg: FrcnnConfig, bucket: int = 64):
    """Device-ingest host half: decode only, NO resize: returns ``(bucket-
    padded original uint8 (bh, bw, 3), (h0, w0), (h1, w1), (ph, pw),
    scale_yx)``; ``device_resize_canvas`` finishes on the device. Returns
    ``None`` when shipping the original would NOT save bytes over the resized
    canvas (very large photos): the caller takes the PIL path for those."""
    arr = _to_rgb_array(img)
    h0, w0 = arr.shape[:2]
    h1, w1, ph, pw = preprocess_geometry(h0, w0, cfg)
    bh = ((h0 + bucket - 1) // bucket) * bucket
    bw = ((w0 + bucket - 1) // bucket) * bucket
    if bh * bw >= ph * pw:
        return None
    out = np.zeros((bh, bw, 3), np.uint8)
    out[:h0, :w0] = arr
    scale_yx = np.asarray([h0 / h1, w0 / w1], np.float32)
    return out, (h0, w0), (h1, w1), (ph, pw), scale_yx


def device_resize_canvas(orig_u8, hw0, hw1, ph: int, pw: int):
    """The bucket-padded uint8 original (a tensor, on the device) resized
    into the detector's float32 canvas (ph, pw, 3): the (h0, w0) image
    through ``F.interpolate(bilinear, align_corners=False)`` to (h1, w1) in
    the top-left, zeros elsewhere. The float branch of the reference
    transform family (detectron2's ``ResizeTransform`` on float inputs)."""
    h0, w0 = (int(v) for v in hw0)
    h1, w1 = (int(v) for v in hw1)
    img = orig_u8[:h0, :w0].permute(2, 0, 1)[None].float()
    resized = F.interpolate(img, size=(h1, w1), mode="bilinear", align_corners=False)
    canvas = torch.zeros((ph, pw, 3), dtype=torch.float32, device=orig_u8.device)
    canvas[:h1, :w1] = resized[0].permute(1, 2, 0)
    return canvas


def normalize_canvas(canvas, size_hw, cfg: FrcnnConfig):
    """Host-side twin of FrcnnStage1's on-device normalization: uint8 RGB
    canvas -> float32 BGR mean-subtracted, pad region zeroed."""
    x = canvas.astype(np.float32)[..., ::-1] - np.asarray(cfg.pixel_mean_bgr, np.float32)
    x[size_hw[0]:, :, :] = 0.0
    x[:, size_hw[1]:, :] = 0.0
    return x


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_frcnn_weights(modules, generator: torch.Generator) -> None:
    """flax's initializers from ``generator``: every conv and dense kernel
    lecun-normal (a normal truncated at two standard deviations, scaled to
    variance 1 / fan_in), biases zero, frozen batch norm at identity."""
    with torch.no_grad():
        for module in modules:
            for m in module.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                          generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, FrozenBN):
                    m.init_constants()


STAGE1_PREFIXES = ("backbone.", "proposal_generator.")


def frcnn_checkpoint_file(weight_path: str) -> str:
    """The checkpoint file a path names: ``pytorch_model.bin`` inside it
    when it is a directory, else the path itself."""
    if os.path.isdir(weight_path):
        return os.path.join(weight_path, "pytorch_model.bin")
    return weight_path


def read_frcnn_checkpoint(weight_path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a ``pytorch_model.bin`` (a file, or a directory
    holding one), its ``"model"`` entry when it has one, read with
    ``weights_only=True``."""
    sd = torch.load(frcnn_checkpoint_file(weight_path), map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


# ---------------------------------------------------------------------------
# Detector orchestration
# ---------------------------------------------------------------------------


class FrcnnDetector:
    """The two stages on ``device`` and the paths through them. Its
    ``state_dict`` is the published layout: stage 1 holds ``backbone.*`` and
    ``proposal_generator.*``, stage 2 ``roi_heads.*``."""

    def __init__(self, cfg: FrcnnConfig = FrcnnConfig(), state_dict=None,
                 generator: Optional[torch.Generator] = None, device="cuda",
                 roi_chunk: int = 256):
        self.cfg = cfg
        self.device = torch.device(device)
        with torch.device("meta"):  # no default init: it is replaced below
            stage1, stage2 = FrcnnStage1(cfg), FrcnnStage2(cfg, roi_chunk)
        self.stage1 = stage1.to_empty(device="cpu")
        self.stage2 = stage2.to_empty(device="cpu")
        if state_dict is None:
            init_frcnn_weights((self.stage1, self.stage2),
                               generator if generator is not None
                               else torch.Generator().manual_seed(0))
        else:
            self.load_state_dict(state_dict)
        self.stage1.to(self.device).eval()
        self.stage2.to(self.device).eval()
        self._anchor_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._anchor_dev: Dict[Tuple[int, int], torch.Tensor] = {}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {**self.stage1.state_dict(), **self.stage2.state_dict()}

    def load_state_dict(self, state_dict) -> None:
        """Strict: a missing or unexpected key, or a shape that differs,
        raises."""
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        self.stage1.load_state_dict({k: v for k, v in sd.items() if k.startswith(STAGE1_PREFIXES)})
        self.stage2.load_state_dict({k: v for k, v in sd.items()
                                     if not k.startswith(STAGE1_PREFIXES)})

    def _anchors(self, grid_h, grid_w):
        key = (grid_h, grid_w)
        if key not in self._anchor_cache:
            self._anchor_cache[key] = generate_anchors(self.cfg, grid_h, grid_w)
        return self._anchor_cache[key]

    def _anchors_on_device(self, grid_h, grid_w):
        key = (grid_h, grid_w)
        if torch.compiler.is_exporting():  # a constant of the program, not a cached tensor
            return torch.from_numpy(self._anchors(grid_h, grid_w)).to(self.device)
        if key not in self._anchor_dev:
            self._anchor_dev[key] = torch.from_numpy(self._anchors(grid_h, grid_w)).to(self.device)
        return self._anchor_dev[key]

    def _rpn_proposals(self, logits, deltas, size_hw):
        """Host half of the RPN over one image's (gh, gw, A) logits and
        (gh, gw, 4A) deltas (numpy): top-k, decode, exact greedy NMS 0.7 and
        the post-NMS cut."""
        cfg = self.cfg
        grid_h, grid_w = logits.shape[:2]
        anchors = self._anchors(grid_h, grid_w)
        scores = np.asarray(logits).reshape(-1)              # (H*W*A,)
        deltas = np.asarray(deltas).reshape(-1, 4)
        k = min(cfg.rpn_pre_nms_topk, scores.shape[0])
        top = np.argpartition(-scores, k - 1)[:k]
        # decoded on the device, with the fused path's arithmetic: the two
        # paths' boxes are the same bits, so their NMS decisions are the same
        boxes = decode_boxes(torch.from_numpy(anchors[top]).to(self.device),
                             torch.from_numpy(deltas[top]).to(self.device), cfg.rpn_bbox_weights)
        boxes = clip_boxes(boxes, float(size_hw[0]), float(size_hw[1])).cpu().numpy()
        ws = boxes[:, 2] - boxes[:, 0]
        hs = boxes[:, 3] - boxes[:, 1]
        alive = (ws > cfg.rpn_min_box_size) & (hs > cfg.rpn_min_box_size)
        boxes, sc = boxes[alive], scores[top][alive]
        keep = greedy_nms(boxes, sc, cfg.rpn_nms_thresh, max_out=cfg.rpn_post_nms_topk)
        return boxes[keep], sc[keep]

    def _select_detections(self, boxes, best, cls):
        """Final per-class selection (host): per-class greedy NMS, the global
        top-36, the min-detection backfill (the reference pads to exactly
        ``max_detections``, obj_features.py:157-164)."""
        cfg = self.cfg
        chosen: list = []
        conf = best >= cfg.box_score_thresh
        for c in np.unique(cls[conf]):
            rows = np.nonzero(conf & (cls == c))[0]
            keep = rows[greedy_nms(boxes[rows], best[rows], cfg.box_nms_thresh)]
            chosen.extend(keep.tolist())
        chosen = sorted(chosen, key=lambda i: -best[i])[: cfg.max_detections]
        if len(chosen) < cfg.min_detections:
            # backfill below threshold / suppressed, highest score first
            taken = set(chosen)
            rest = [i for i in np.argsort(-best) if i not in taken]
            chosen = (chosen + rest)[: cfg.min_detections]
        idx = np.asarray(chosen, np.int64)
        return idx, boxes[idx], best[idx], cls[idx]

    # ---- the fused path -------------------------------------------------

    def _rpn_candidates(self, logits, deltas, size_hw):
        """The device RPN's NMS input over a window: top-k (ties by anchor
        index, as ``lax.top_k``), decode, clip, then the boxes sorted by
        score with the dead ones at the back -> (B, k, 4) boxes and (B, k)
        alive flags."""
        cfg = self.cfg
        b, _, gh, gw = logits.shape
        anchors = self._anchors_on_device(gh, gw)
        scores = logits.permute(0, 2, 3, 1).reshape(b, -1)
        dl = deltas.permute(0, 2, 3, 1).reshape(b, -1, 4)
        k = min(cfg.rpn_pre_nms_topk, scores.shape[1])
        sc, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        sc, idx = sc[:, :k], idx[:, :k]
        bx = decode_boxes(anchors[idx], torch.gather(dl, 1, idx[..., None].expand(b, k, 4)),
                          cfg.rpn_bbox_weights)
        bx = clip_boxes(bx, size_hw[:, 0, None], size_hw[:, 1, None])
        alive = (((bx[..., 2] - bx[..., 0]) > cfg.rpn_min_box_size)
                 & ((bx[..., 3] - bx[..., 1]) > cfg.rpn_min_box_size))
        inf = torch.full((), float("inf"), device=sc.device)
        order = torch.sort(torch.where(alive, -sc, inf), dim=1, stable=True).indices
        return torch.gather(bx, 1, order[..., None].expand(b, k, 4)), torch.gather(alive, 1, order)

    def _rpn_device(self, logits, deltas, size_hw):
        """Device RPN of a window: ``_rpn_candidates``, the blocked greedy
        NMS over all the images in lockstep, the post-NMS cut -> (B, post,
        4) proposals (rows past the kept count zero) and (B,) kept counts."""
        n_post = self.cfg.rpn_post_nms_topk
        bx, alive = self._rpn_candidates(logits, deltas, size_hw)
        b = bx.shape[0]
        keep, cnt = nms_keep(bx, alive, self.cfg.rpn_nms_thresh, n_post)
        sel = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :n_post]
        mask = torch.arange(sel.shape[1], device=sel.device)[None] < cnt[:, None]
        props = torch.gather(bx, 1, sel[..., None].expand(b, sel.shape[1], 4))
        return torch.where(mask[..., None], props, torch.zeros((), device=props.device)), cnt

    def _select_device(self, feats, best, cls, det, nvalid, size_hw):
        """Device per-class selection of a window: one group-masked greedy
        scan over the global score order, then the ranking key kept + best
        (kept rows first, score descending, then the backfill) and the top
        ``max_detections`` -> (feats, normalized boxes, scores, classes
        (-1 past the count), counts)."""
        cfg = self.cfg
        b, n = best.shape
        dev = best.device
        rows = torch.arange(n, device=dev)[None]
        row_ok = rows < nvalid[:, None]
        conf = row_ok & (best >= cfg.box_score_thresh)
        inf = torch.full((), float("inf"), device=dev)
        order = torch.sort(torch.where(conf, -best, inf), dim=1, stable=True).indices
        keep_s, _ = nms_keep(
            torch.gather(det, 1, order[..., None].expand(b, n, 4)), torch.gather(conf, 1, order),
            cfg.box_nms_thresh, n, group=torch.gather(cls, 1, order))
        kept = torch.zeros_like(keep_s).scatter(1, order, keep_s)
        key = torch.where(row_ok, best + kept.float() * 2.0, -inf)
        top = torch.sort(-key, dim=1, stable=True).indices[:, :cfg.max_detections]
        cnt = torch.clamp(nvalid, max=cfg.max_detections)
        m = torch.arange(top.shape[1], device=dev)[None] < cnt[:, None]
        wh = torch.stack([size_hw[:, 1], size_hw[:, 0], size_hw[:, 1], size_hw[:, 0]], -1)
        zero = torch.zeros((), device=dev)
        norm = torch.gather(det, 1, top[..., None].expand(*top.shape, 4)) / wh[:, None]
        out_f = torch.gather(feats, 1, top[..., None].expand(*top.shape, feats.shape[-1]))
        return (torch.where(m[..., None], out_f, zero), torch.where(m[..., None], norm, zero),
                torch.where(m, torch.gather(best, 1, top), zero),
                torch.where(m, torch.gather(cls, 1, top), -1), cnt)

    def _dispatch(self, canvases, sizes):
        """Stage 1, the device RPN and stage 2 of one orientation group;
        stage 2 is enqueued, not waited for."""
        with torch.inference_mode():
            with torch.profiler.record_function("frcnn.backbone_rpn"):
                fmap, logits, deltas = self.stage1(canvases, sizes)
            with torch.profiler.record_function("frcnn.rpn_nms"):
                props, nvalid = self._rpn_device(logits, deltas, sizes)
            with torch.profiler.record_function("frcnn.roi_heads"):
                feats, best, cls, det = self.stage2(fmap, props, sizes)
        return feats, best, cls, det, nvalid, sizes

    def _finish_fused(self, handle) -> list:
        n_imgs, pending = handle
        results: list = [None] * n_imgs
        for idxs, dev in pending:
            with torch.inference_mode(), torch.profiler.record_function("frcnn.selection"):
                out = self._select_device(*dev)
                feats, boxes, scores, classes, _ = (t.cpu().numpy() for t in out)
            for j, i in enumerate(idxs):
                results[i] = {
                    "roi_features": feats[j],
                    "normalized_boxes": boxes[j],
                    "scores": scores[j],
                    "classes": classes[j].astype(np.int64),
                }
        return results

    def prepare_batch(self, imgs, ingest: str = "pil"):
        """The host half of the fused path, with no device work: each image
        resized into its canvas (``pil``) or, under ``ingest="device"``,
        padded to its bucket unresized (an image whose original is not
        smaller than the canvas takes the PIL path), grouped by canvas
        orientation -> ``(n_imgs, [(indices, (ph, pw), rows, (B, 2)
        sizes)])`` for ``detect_prepared_async``. ``rows`` holds the (B, ph,
        pw, 3) uint8 canvases, or under device ingest each image's ``("pil",
        canvas)`` or ``("dev", original, hw0, hw1)``. Numpy and PIL only, so
        a thread can prepare the next images while the card works."""
        cfg = self.cfg
        groups: Dict[tuple, list] = {}
        pre = []
        for i, im in enumerate(imgs):
            r = preprocess_image_original(im, cfg) if ingest == "device" else None
            if r is None:
                canvas, hw1, _ = preprocess_image(im, cfg)
                pre.append((("pil", canvas), hw1))
                groups.setdefault(canvas.shape[:2], []).append(i)
            else:
                orig, hw0, hw1, canvas_hw, _ = r
                pre.append((("dev", orig, hw0, hw1), hw1))
                groups.setdefault(tuple(canvas_hw), []).append(i)
        out = []
        for canvas_hw, idxs in groups.items():
            rows = [pre[i][0] for i in idxs]
            if ingest != "device":
                rows = np.stack([row[1] for row in rows])
            out.append((idxs, canvas_hw, rows,
                        np.asarray([pre[i][1] for i in idxs], np.float32)))
        return len(imgs), out

    def _canvases(self, rows, ph: int, pw: int):
        """The device half of device ingest: each image's float32 canvas,
        the original resized on the device, or the PIL canvas as it is."""
        return torch.stack([
            torch.from_numpy(r[1]).to(self.device).float() if r[0] == "pil"
            else device_resize_canvas(torch.from_numpy(r[1]).to(self.device), r[2], r[3], ph, pw)
            for r in rows])

    def detect_prepared_async(self, prepared):
        """Run a ``prepare_batch`` result: stage 1, the device RPN and
        stage 2 of each orientation group. The RPN's NMS reads a flag on
        the host every block step, so this returns once stage 1 and the RPN
        are done and stage 2 is enqueued; the returned zero-argument callable
        runs the per-class selection and copies the 36 regions to the
        host."""
        n_imgs, groups = prepared
        pending = []
        with torch.inference_mode():
            for idxs, (ph, pw), rows, sizes in groups:
                canv = (torch.from_numpy(rows).to(self.device) if isinstance(rows, np.ndarray)
                        else self._canvases(rows, ph, pw))
                pending.append((idxs, self._dispatch(canv, torch.from_numpy(sizes).to(self.device))))
        handle = (n_imgs, pending)
        return lambda: self._finish_fused(handle)

    def detect(self, img) -> Dict[str, np.ndarray]:
        """Raw RGB image (array or PIL) -> dict with ``roi_features``
        (max_detections, feat_dim), ``normalized_boxes`` (max_detections, 4)
        in [0,1] of the resized image, plus scores/classes."""
        return self.detect_batch([img])[0]

    def detect_batch_async(self, imgs, pad_to: Optional[int] = None, ingest: str = "pil"):
        """The fused ``detect_batch`` split before the selection:
        ``prepare_batch`` then ``detect_prepared_async``; the returned
        zero-argument callable runs the per-class selection and copies the
        results to the host. Its results equal ``detect_batch``'s."""
        del pad_to  # nothing is padded (module docstring)
        return self.detect_prepared_async(self.prepare_batch(imgs, ingest))

    def detect_batch(self, imgs, pad_to: Optional[int] = None, fused: bool = True,
                     ingest: str = "pil") -> list:
        """Batched inference over a list of raw images, grouped by canvas
        orientation; per-image results are those of ``detect``.

        ``fused=True``: stage 1, the device RPN NMS, stage 2 and the device
        per-class selection; only the final regions cross to the host.
        ``fused=False``: the staged path (host NMS between the device
        stages). ``ingest="device"`` (fused only) resizes the original pixels
        on the device (module docstring)."""
        if ingest == "device" and not fused:
            raise ValueError("ingest='device' requires the fused path")
        if fused:
            return self.detect_batch_async(imgs, pad_to, ingest=ingest)()
        cfg = self.cfg
        n = cfg.rpn_post_nms_topk
        pre = [preprocess_image(im, cfg) for im in imgs]
        groups: Dict[tuple, list] = {}
        for i, (canvas, _, _) in enumerate(pre):
            groups.setdefault(canvas.shape, []).append(i)
        results: list = [None] * len(imgs)
        for _, idxs in groups.items():
            bp = len(idxs)
            canv = torch.from_numpy(np.stack([pre[i][0] for i in idxs])).to(self.device)
            sizes = torch.tensor([pre[i][1] for i in idxs], dtype=torch.float32,
                                 device=self.device)
            with torch.inference_mode():
                fmap, logits, deltas = self.stage1(canv, sizes)
                logits_h = logits.permute(0, 2, 3, 1).cpu().numpy()
                deltas_h = deltas.permute(0, 2, 3, 1).cpu().numpy()
                # a fixed proposal count for stage 2 (pad + mask)
                props = np.zeros((bp, n, 4), np.float32)
                valid = np.zeros(bp, np.int64)
                for j, i in enumerate(idxs):
                    p, _ = self._rpn_proposals(logits_h[j], deltas_h[j], pre[i][1])
                    props[j, : p.shape[0]] = p
                    valid[j] = p.shape[0]
                feats, best_d, cls_d, det_d = self.stage2(
                    fmap, torch.from_numpy(props).to(self.device), sizes)
                best_h, cls_h, det_h = (t.cpu().numpy() for t in (best_d, cls_d, det_d))
                # gather ONLY the chosen feature rows on the device; the
                # (B, n, feat_dim) features never cross to the host
                pad_idx = np.zeros((bp, cfg.max_detections), np.int64)
                sel = []
                for j in range(bp):
                    v = int(valid[j])
                    chosen = self._select_detections(det_h[j, :v], best_h[j, :v], cls_h[j, :v])
                    pad_idx[j, : len(chosen[0])] = chosen[0]
                    sel.append(chosen)
                rows = torch.arange(bp, device=self.device)[:, None]
                feats_sel = feats[rows, torch.from_numpy(pad_idx).to(self.device)].cpu().numpy()
            for j, i in enumerate(idxs):
                idx, boxes, best, cls = sel[j]
                size_hw = pre[i][1]
                norm = boxes / np.asarray([size_hw[1], size_hw[0], size_hw[1], size_hw[0]],
                                          np.float32)
                out = {
                    "roi_features": feats_sel[j, : len(idx)],
                    "normalized_boxes": norm.astype(np.float32),
                    "scores": best.astype(np.float32),
                    "classes": cls.astype(np.int64),
                }
                # an image can leave fewer proposals than min_detections:
                # zero-pad to the fixed region count (the reference's
                # padding="max_detections" contract, obj_features.py:157-164)
                short = cfg.max_detections - len(idx)
                if short > 0:
                    for key, v2 in out.items():
                        pad = np.zeros((short,) + v2.shape[1:], v2.dtype)
                        out[key] = np.concatenate([v2, pad - (key == "classes")])
                results[i] = out
        return results


class FusedDetectProgram(nn.Module):
    """The fused path of ``detector`` over one batch of padded canvases as a
    module, for ``torch.export``: ``forward(canvases, size_hw)`` with (B, Hp,
    Wp, 3) uint8 RGB canvases (``preprocess_image``) and (B, 2) float32
    valid (resized_h, resized_w) -> the 36-region tensors of
    ``_select_device`` (features, normalized boxes, scores, classes, counts).
    It runs the detector's own stages and methods, so it gives what
    ``detect_batch`` gives; the stages are its submodules (the program's
    weights)."""

    def __init__(self, detector: FrcnnDetector):
        super().__init__()
        self.stage1, self.stage2 = detector.stage1, detector.stage2
        self.detector = detector

    def forward(self, canvases, size_hw):
        fmap, logits, deltas = self.stage1(canvases, size_hw)
        props, nvalid = self.detector._rpn_device(logits, deltas, size_hw)
        feats, best, cls, det = self.stage2(fmap, props, size_hw)
        return self.detector._select_device(feats, best, cls, det, nvalid, size_hw)


def import_frcnn_state_dict(sd, cfg: FrcnnConfig, device="cuda") -> FrcnnDetector:
    """A detector from a state dict in the published key layout
    (``backbone.stem.conv1`` / ``backbone.res{2..4}.{i}`` /
    ``proposal_generator.rpn_head`` / ``roi_heads.res5.{i}`` /
    ``roi_heads.box_predictor``), loaded strictly."""
    return FrcnnDetector(cfg, state_dict=sd, device=device)


def load_frcnn(weight_path: str, cfg: FrcnnConfig = FrcnnConfig(), device="cuda"):
    """Build a detector from a torch checkpoint file/dir (``pytorch_model
    .bin`` layout of unc-nlp/frcnn-vg-finetuned)."""
    det = import_frcnn_state_dict(read_frcnn_checkpoint(weight_path), cfg, device=device)
    logger.info("FRCNN weights imported from %s", weight_path)
    return det
