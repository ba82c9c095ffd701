"""Pooling and feature helpers (reference ``models/utils.py:46-107,234-243``).

Counterpart of the JAX package's ``utils/pooling.py``, as plain functions on
tensors. ``conv_kernel_summary`` takes a module and lists what the JAX
function lists on the module's carried parameter tree.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..models.from_jax import _flax_path, frcnn_flax_path
from ..models.frcnn import FrcnnStage1, FrcnnStage2


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor] = None, dim: int = 1):
    """Mean over ``dim`` counting only unmasked positions
    (reference utils.py:80-92)."""
    if mask is None:
        return x.mean(dim=dim)
    m = mask[:, :x.shape[dim]].to(x.dtype)[..., None]
    return (x * m).sum(dim=dim) / torch.clamp(m.sum(dim=dim), min=1e-9)


def masked_max(x: torch.Tensor, mask: Optional[torch.Tensor] = None, dim: int = 1):
    """Max over ``dim`` with masked positions at -1e9
    (reference utils.py:95-107)."""
    if mask is None:
        return x.amax(dim=dim)
    m = mask[:, :x.shape[dim]].bool()[..., None]
    return torch.where(m, x, torch.full((), -1e9, dtype=x.dtype, device=x.device)).amax(dim=dim)


def batch_cosine_similarity(x_t: torch.Tensor, x_v: torch.Tensor) -> torch.Tensor:
    """Per-row cosine similarity of two (B, D) feature matrices
    (reference compute_batch_dot_product, utils.py:234-243)."""
    t = x_t / torch.linalg.vector_norm(x_t, dim=-1, keepdim=True)
    v = x_v / torch.linalg.vector_norm(x_v, dim=-1, keepdim=True)
    return (t * v).sum(dim=-1)


def conv_kernel_summary(module: nn.Module) -> List[Tuple[str, tuple]]:
    """Conv-layer introspection (reference ``get_conv_layers``, utils.py:46-70):
    ``(path, HWIO kernel shape)`` of every convolution, the path the kernel
    has in the module's JAX parameter tree (``params/.../kernel``, the
    layout of ``models/from_jax.py``; a detector stage's in the JAX stage's
    own tree), in the tree's flattening order (keys sorted at every level),
    as the JAX function returns them."""
    path_of = frcnn_flax_path if isinstance(module, (FrcnnStage1, FrcnnStage2)) else _flax_path
    out = []
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Conv2d):
            cout, cin, kh, kw = mod.weight.shape
            out.append((("params", *path_of(name), "kernel"), (kh, kw, cin, cout)))
    return [("/".join(keys), shape) for keys, shape in sorted(out)]
