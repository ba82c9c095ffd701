"""Final artifacts, and checkpoints to resume from.

Counterpart of the JAX package's ``train/checkpoint.py``, in two tiers:

* the final artifact: ``save_params``/``load_params``, one file per trained
  model under the reference's name contract (``...{loss_str}_{N}net.pth``).
  ``save_params`` writes a torch ``state_dict``. ``load_params`` reads that,
  or the JAX package's artifact under the same name: a flax msgpack of the
  parameter tree (unrolled or in the ``--scan_layers`` layout), read by
  ``train/flax_msgpack.py`` and mapped by ``models/from_jax.py``. The two
  are told apart by their first bytes, never by the name.
* mid-training checkpoints (``--ckpt_every N`` / ``--resume``):
  ``TrainCheckpointer`` in place of the JAX package's Orbax manager, which
  the port does not have. Every checkpoint is one torch file
  ``{directory}/step_{step}.pt`` of plain tensors, numbers and dicts (the
  trainer's state: parameters, AdamW's moments and count, under
  ``--opt_impl lazy_emb`` the word table's lazy moments and count beside
  them, step, epoch, the generators' states), written to a temporary name
  and renamed, so a checkpoint on disk is always whole; the newest ``max_to_keep`` are kept.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..utils.logging import get_logger

logger = get_logger(__name__)


def save_params(path: str, module) -> None:
    """``module``'s state dict (or a state dict) as a torch file on the CPU."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = module if isinstance(module, dict) else module.state_dict()
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)
    logger.info("%s saved", path)


def load_params(path: str, module: nn.Module) -> nn.Module:
    """Load ``path`` into ``module`` strictly: a missing or unexpected key,
    or a shape that differs, raises. Returns the module.

    ``path`` is a torch file (``save_params``) or a JAX artifact (a msgpack
    map; its layout, unrolled or ``layers/layer``, is read from the tree,
    and a scanned stack's pad slots past the module's layers are dropped)."""
    from ..models.from_jax import layer_counts, torch_state_from_jax
    from . import flax_msgpack

    with open(path, "rb") as f:
        head = f.read(1)
    if flax_msgpack.is_msgpack_tree(head):
        tree = flax_msgpack.read_file(path)
        state = {k: torch.from_numpy(v) for k, v in torch_state_from_jax(tree, layer_counts(module)).items()}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state, strict=True)
    return module


class TrainCheckpointer:
    """Periodic checkpoints with resume; ``every_steps`` is read by the
    trainer, which decides when to save."""

    _NAME = re.compile(r"step_(\d+)\.pt$")

    def __init__(self, directory: str, every_steps: int = 200, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.every_steps = every_steps
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        """The steps of the checkpoints on disk, oldest first."""
        found = (self._NAME.search(p) for p in glob.glob(os.path.join(self.directory, "step_*.pt")))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        path = os.path.join(self.directory, f"step_{step}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"step_{old}.pt"))
        logger.info("checkpoint at step %d saved in %s", step, self.directory)

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self.directory, f"step_{step}.pt"),
                           map_location="cpu", weights_only=True)
        logger.info("restored checkpoint at step %d from %s", step, self.directory)
        return state
