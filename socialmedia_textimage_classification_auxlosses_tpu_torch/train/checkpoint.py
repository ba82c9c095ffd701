"""Final-artifact save/load.

Counterpart of ``save_params``/``load_params`` in the JAX package's
``train/checkpoint.py``: one file per trained model under the reference's
name contract (``...{loss_str}_{N}net.pth``). Here the file is a torch
``state_dict``; reading the JAX package's flax msgpack artifacts is not
ported yet.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..utils.logging import get_logger

logger = get_logger(__name__)


def save_params(path: str, module: nn.Module) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, path)
    logger.info("%s saved", path)


def load_params(path: str, module: nn.Module) -> nn.Module:
    """Load ``path`` into ``module`` strictly: a missing or unexpected key,
    or a shape that differs, raises. Returns the module."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state, strict=True)
    return module
