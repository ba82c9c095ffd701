"""Shared CLI plumbing: architecture presets, artifact names, seeding.

Counterpart of the JAX package's ``cli/_common.py`` (the parts serving uses).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

ARCH_PRESETS = {
    "base": {},
    "small": dict(hidden=256, layers=4, heads=4, mlp_dim=512),
    "tiny": dict(hidden=64, layers=2, heads=2, mlp_dim=128),
}


def arch_overrides(args) -> dict:
    return dict(ARCH_PRESETS[args.arch])


def artifact_stem(args, cfg) -> str:
    """The late-fusion artifact naming contract, shared with the JAX
    package's trainers (``{txt}-{img}-{fusion}_task{t}_seed{s}_{loss_str}_{N}``)."""
    nsamples = getattr(args, "nsamples", -1)
    nsamples_str = "" if nsamples == -1 else f"N{nsamples}_"
    return "{}-{}-{}_task{}_seed{}_{}_{}".format(
        args.txt_model_name, args.img_model_name, args.fusion_name,
        args.task, args.seed, cfg.loss_str, nsamples_str)


def results_dir_for(base: str, testing: bool) -> str:
    out = base + ("testing/" if testing else "")
    os.makedirs(out, exist_ok=True)
    return out


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a CPU
    ``torch.Generator`` seeded the same, for explicit random init."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default of every entry point) or ``cpu``. Asking for
    CUDA where there is none raises: nothing falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass --device cpu "
            "(device='cpu') to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return device
