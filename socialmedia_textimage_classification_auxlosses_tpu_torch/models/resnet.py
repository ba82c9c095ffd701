"""ResNet-50/152, the conv self-attention and its classifier.

Counterpart of the JAX package's ``models/resnet.py``: bottleneck-v1 blocks
in torchvision's topology (so ``hf_import.import_resnet`` maps a torchvision
state dict), convolutions in ``dtype``, batch-norm statistics and output in
float32, the next convolution casting back, as the flax modules do. The
convolutions and the max-pool are ``torch.nn.functional`` calls: the JAX
package leaves them to XLA, not to a Pallas kernel.

``BatchNorm`` follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
dtype=float32)``, not ``nn.BatchNorm2d``: in training it normalises with the
batch's mean and biased variance and updates the running buffers with that
same biased variance, ``ra = 0.9 ra + 0.1 stat`` (``nn.BatchNorm2d`` would
take the unbiased one); in eval it normalises with the buffers. Both
normalisations are PyTorch's own batch-norm kernels (one launch forward, one
backward, in place of a dozen elementwise ones); the training one hands back
the batch statistics the update needs (flax forms the variance as
E[x^2] - E[x]^2, PyTorch by Welford's method: equal within float32's
rounding). It keeps no ``num_batches_tracked``. Its buffers
``running_mean`` / ``running_var`` are flax's ``batch_stats`` ``mean`` /
``var`` (``models/from_jax.py``), and stay outside AdamW. Whether a forward trains the statistics is the explicit
``train`` argument (flax's ``use_running_average = not train``), not the
module's mode: ``--feature_extract`` trains the head with them frozen.

Names follow the flax tree (``stem_conv``, ``stage{s}_block{b}``, ``conv1``,
``bn1``, ..., ``down_conv``, ``down_bn``, ``fc``; the classifier's
``trunk``, ``self_attn``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

STAGE_SIZES = {
    "resnet50": (3, 4, 6, 3),
    "resnet152": (3, 8, 36, 3),
}


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over NCHW channels, float32 in and out."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def init_constants(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x, w, b = x.float(), self.weight.float(), self.bias.float()
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, w, b, False, 0.0,
                                self.eps)
        # one normalisation with the batch's statistics (its backward through
        # them included); it hands back the mean and 1/sqrt(var + eps) of the
        # biased variance, which then update the buffers as flax does
        y, mean, invstd = torch.native_batch_norm(x, w, b, None, None, True, 0.0, self.eps)
        with torch.no_grad():  # in place: a captured CUDA graph updates the same buffers
            var = invstd.pow(-2).sub_(self.eps).clamp_min_(0.0)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return y


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Conv(dtype=dtype)``: input and kernel cast to ``dtype``, the
    bias (when there is one) added after the convolution is rounded."""
    y = F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride, layer.padding)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)[:, None, None]
    return y


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dtype: str = "float32"):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        out = features * 4
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=strides, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        if in_channels != out or strides != 1:
            self.down_conv = nn.Conv2d(in_channels, out, 1, stride=strides, bias=False)
            self.down_bn = BatchNorm(out)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x, train: bool = False):
        dt = self.dtype
        y = F.relu(self.bn1(conv(self.conv1, x, dt), train))
        y = F.relu(self.bn2(conv(self.conv2, y, dt), train))
        y = self.bn3(conv(self.conv3, y, dt), train)
        residual = x
        if self.down_conv is not None:
            residual = self.down_bn(conv(self.down_conv, x, dt), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Stem, the bottleneck stages and ``fc`` over the mean-pooled final map
    (float32). ``forward(pixels, train, return_features)``; pixels NHWC (or
    NCHW, told apart by the channel axis); the features come back NCHW."""

    def __init__(self, stage_sizes: Sequence[int], num_labels: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.stem_conv = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(64)
        self.blocks = []
        channels = 64
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                name = f"stage{stage}_block{block}"
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(name, Bottleneck(channels, 64 * 2 ** stage, strides, dtype))
                self.blocks.append(name)
                channels = 64 * 2 ** stage * 4
        self.fc = nn.Linear(channels, num_labels)

    def forward(self, pixel_values, train: bool = False, return_features: bool = False):
        x = pixel_values
        if x.shape[1] != 3:
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.stem_bn(conv(self.stem_conv, x, self.dtype), train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        logits = self.fc(x.mean(dim=(2, 3)).float())
        return (logits, x) if return_features else logits


class ConvSelfAttention(nn.Module):
    """SAGAN-style conv self-attention: 1x1 query/key/value convolutions,
    softmax over the positions (float32, cast back), a ``gamma``-gated
    residual. Returns (out, attention), NCHW."""

    def __init__(self, in_dim: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.query = nn.Conv2d(in_dim, in_dim // 8, 1)
        self.key = nn.Conv2d(in_dim, in_dim // 8, 1)
        self.value = nn.Conv2d(in_dim, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def init_constants(self) -> None:
        self.gamma.zero_()

    def forward(self, x):
        dt = self.dtype
        b, c, h, w = x.shape

        def tokens(layer):  # (B, H·W, C'), positions row-major as flax reshapes NHWC
            return conv(layer, x, dt).flatten(2).transpose(1, 2)

        q, k, v = tokens(self.query), tokens(self.key), tokens(self.value)
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)).float(), dim=-1).to(dt)
        out = torch.bmm(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return self.gamma.to(dt) * out + x, attn


class ResNetAttnClassifier(nn.Module):
    """ResNet trunk + conv self-attention over its final map + ``fc``."""

    def __init__(self, stage_sizes: Sequence[int], num_labels: int, dtype: str = "float32"):
        super().__init__()
        self.trunk = ResNet(stage_sizes, num_labels, dtype=dtype)
        self.self_attn = ConvSelfAttention(self.trunk.fc.in_features, dtype=dtype)
        self.fc = nn.Linear(self.trunk.fc.in_features, num_labels)

    def forward(self, pixel_values, train: bool = False):
        _, fmap = self.trunk(pixel_values, train, return_features=True)
        attended, _ = self.self_attn(fmap)
        return self.fc(attended.mean(dim=(2, 3)).float())


def build_resnet_classifier(model_name: str, num_labels: int, dtype: str = "float32",
                            conv_att: bool = False) -> nn.Module:
    sizes = STAGE_SIZES[model_name]
    if conv_att:
        return ResNetAttnClassifier(sizes, num_labels, dtype=dtype)
    return ResNet(sizes, num_labels, dtype=dtype)
