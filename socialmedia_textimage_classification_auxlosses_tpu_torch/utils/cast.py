"""Serving-time parameter pre-cast: tower weights stored in the compute dtype.

Counterpart of the JAX package's ``utils/cast.py``. The models keep float32
parameters and cast each weight to the compute dtype where it is used
(``models/encoder.py::dense``); for serving, that rounding is done once, in
place, so the forward reads half the weight bytes and gives the same outputs.
Parameters consumed at float32 stay float32, by the same rule as the JAX
package: LayerNorms, the classification and auxiliary heads, the fusion
head, the dual-encoder projections and ``logit_scale``.
"""

from __future__ import annotations

import torch
from torch import nn

# Module-path segments whose parameters are consumed at float32.
_F32_HEAD_SEGMENTS = frozenset({
    "linear", "linear_cls", "linear_tim", "linear_iadds",
    "classifier", "fc", "text_proj", "visual_proj",
    "logit_scale", "rel_pos_table", "batch_stats",
    "fusion", "linear_fusion", "conv_proj",
})


def keeps_f32(name: str) -> bool:
    """Whether the parameter at state-dict key ``name`` stays float32."""
    for seg in name.lower().split("."):
        if seg == "ln" or seg.startswith("ln_") or seg.endswith("_ln"):
            return True
        if "layernorm" in seg or seg == "norm":
            return True
        if seg.startswith("bn") or seg.endswith("bn"):
            return True
        if seg in _F32_HEAD_SEGMENTS:
            return True
    return False


def cast_params_for_eval(module: nn.Module, compute_dtype) -> nn.Module:
    """Round ``module``'s float32 tower parameters to ``compute_dtype`` in
    place (nothing changes unless it is a float type narrower than float32).
    Returns the module."""
    dt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    if dt == torch.float32 or not dt.is_floating_point:
        return module
    for name, p in module.named_parameters():
        if p.dtype == torch.float32 and not keeps_f32(name):
            p.data = p.data.to(dt)
    return module
