"""Time the port's bf16 and float32 SDPA kernels (forward, backward) beside
``scaled_dot_product_attention`` on the card, for one or more checkouts.

    python3 tools/time_sdpa.py [--shapes TEXT] ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (``.`` for this one;
an older commit unpacked with ``git archive`` under ``build/``). Each runs in
a process of its own that imports the port from ROOT and builds its kernels
there, so two versions are compared on one card in one call: give them in
turns (parent, change, change, parent). For each shape of the main path's
bf16 and float32 attentions (TPU kernels 1-4; float32: the grid's towers and
ViLT exact) it prints one JSON line: the root, the shape, the forward
kernel's device ms, the backward's as the autograd function calls it (with
the forward's row statistics where the port keeps them) and without them,
and the library's forward and backward
(``F.scaled_dot_product_attention`` and its autograd backward, a yardstick
the port never calls), each from ``chip_smoke.device_ms``. The card's name and
power limit come first. ``--shapes TEXT`` times only the shapes whose name
holds TEXT (``--shapes f32``: the float32 ones). Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (batch, heads, lq, lk, head dim, masked[, dtype]); rows 1-4 of
# PERF.md's table, bfloat16 unless named
SHAPES = {
    "f32 16x12x197": (16, 12, 197, 197, 64, False, "float32"),
    "f32 32x12x197": (32, 12, 197, 197, 64, False, "float32"),
    "f32 16x12x128 masked": (16, 12, 128, 128, 64, True, "float32"),
    "f32 32x12x128 masked": (32, 12, 128, 128, 64, True, "float32"),
    "f32 64x12x128 masked": (64, 12, 128, 128, 64, True, "float32"),
    "f32 vilt exact 32x12x402 masked": (32, 12, 402, 402, 64, True, "float32"),
    "image 16x12x197": (16, 12, 197, 197, 64, False),
    "sweep image 48x12x197": (48, 12, 197, 197, 64, False),
    "deit 16x12x198": (16, 12, 198, 198, 64, False),
    "text 16x12x128 masked": (16, 12, 128, 128, 64, True),
    "text 32x12x128 masked": (32, 12, 128, 128, 64, True),
    "sweep text 96x12x128 masked": (96, 12, 128, 128, 64, True),
    "vilt fixed 32x12x185 masked": (32, 12, 185, 185, 64, True),
    "vilt exact 32x12x402 masked": (32, 12, 402, 402, 64, True),
    "lxmert 32x12x36x36 masked": (32, 12, 36, 36, 64, True),
    "lxmert 32x12x36x128 masked": (32, 12, 36, 128, 64, True),
    "lxmert 32x12x128x36": (32, 12, 128, 36, 64, False),
    "mmbt 32x12x132 masked": (32, 12, 132, 132, 64, True),
    "bucket 32x12x96 masked": (32, 12, 96, 96, 64, True),
}


def run_root(root: str, only: str = "") -> None:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, HERE)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import _cuda
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention as A

    _cuda.build(["sdpa_fwd", "sdpa_bwd"])
    g = torch.Generator(device="cuda").manual_seed(0)
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._common import (
        set_precision_policy)

    set_precision_policy()  # float32 plain products without TF32
    for name, (b, h, lq, lk, d, masked, *dtype) in SHAPES.items():
        if only not in name:
            continue
        dt = getattr(torch, dtype[0] if dtype else "bfloat16")
        q, k, v, do = (torch.randn(b, h, n, d, generator=g, device="cuda").to(dt)
                       for n in (lq, lk, lk, lq))
        mask = None
        if masked:
            lens = torch.randint(2, lk + 1, (b,), generator=g, device="cuda")
            mask = (torch.arange(lk, device="cuda")[None] < lens[:, None]).to(torch.int32)
        scale = d ** -0.5
        row = {"root": root, "shape": name}
        with torch.no_grad():
            row["fwd_ms"] = cs.device_ms(torch, lambda: A.sdpa_fwd_cuda(q, k, v, mask, scale))
            try:
                _, stats = A.sdpa_fwd_cuda(q, k, v, mask, scale, with_stats=True)
            except (TypeError, RuntimeError):  # a port whose forward keeps none here
                stats = None
            row["bwd_ms"] = cs.device_ms(
                torch, lambda: A.sdpa_bwd_cuda(q, k, v, mask, do, scale, **(
                    {"stats": stats} if stats is not None else {})))
            row["bwd_no_stats_ms"] = cs.device_ms(
                torch, lambda: A.sdpa_bwd_cuda(q, k, v, mask, do, scale))
            attn = None if mask is None else (mask > 0)[:, None, None, :]
            row["library_fwd_ms"] = cs.device_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn, scale=scale))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=attn, scale=scale)
        row["library_bwd_ms"] = cs.device_ms(
            torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
        print(json.dumps(row), flush=True)
        del q, k, v, do, leaves, out
        torch.cuda.empty_cache()


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        run_root(*argv[1:3])
        return 0
    only = ""
    if len(argv) >= 2 and argv[0] == "--shapes":
        only, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("time_sdpa: CUDA is not available", file=sys.stderr)
        return 2
    print(json.dumps({"card": cs.card_line()}), flush=True)
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, only],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
