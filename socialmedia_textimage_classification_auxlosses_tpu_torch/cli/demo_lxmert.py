"""Single-image LXMERT probe: image -> object features -> the cross-modal
encoder -> probabilities.

Counterpart of the JAX package's ``cli/demo_lxmert.py`` (reference
``models/lxmert.py:36-73``): the image's ROI features from the grid trunk
(``--obj_source grid``, default) or the port's Faster R-CNN (``frcnn``,
``models/frcnn.py``; ``TINY`` geometry at ``--arch tiny``), through a random
LXMERT made from seed 0 (``tiny``: hidden 64, 2 / 1 / 1 layers; ``small``:
hidden 256, 4 / 2 / 2; ``base``: the published 9 / 5 / 5), on the card unless
``--device cpu``:

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.demo_lxmert \\
        --image path.jpg --text "a tweet" [--num_labels 2] [--obj_source frcnn]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger(__name__)

DIMS = {"tiny": dict(hidden=64, heads=2, mlp_dim=128, l_layers=2, r_layers=1, x_layers=1),
        "small": dict(hidden=256, heads=4, mlp_dim=512, l_layers=4, r_layers=2, x_layers=2),
        "base": dict()}


def main(argv=None):
    parser = argparse.ArgumentParser(description="LXMERT single-sample probe")
    parser.add_argument("--image", type=str, required=True)
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--num_labels", type=int, default=2)
    parser.add_argument("--arch", type=str, default="tiny", choices=["tiny", "small", "base"])
    parser.add_argument("--obj_source", type=str, default="grid", choices=["grid", "frcnn"],
                        help="object features: grid pseudo-ROIs (fast) or the Faster R-CNN "
                             "detector (models/frcnn.py)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..core import config as C
    from ..data.cache import RoiFeatureCache
    from ..data.tokenizers import build_tokenizer
    from ..models.lxmert import LxmertClassifier, LxmertConfig, init_lxmert_weights
    from ._common import resolve_device
    from .obj_features import extract_frcnn_features, extract_grid_features

    device = resolve_device(args.device)
    tiny = args.arch == "tiny"
    # 1) object features of the one image (a literal path has no {} and
    # passes through .format() unchanged)
    with tempfile.TemporaryDirectory() as td:
        cache = RoiFeatureCache(td)
        if args.obj_source == "frcnn":
            extract_frcnn_features(["demo"], args.image, cache, tiny=tiny, device=device)
        else:
            extract_grid_features(["demo"], args.image, cache, tiny=tiny, device=device)
        feats, boxes = cache.gather(["demo"])

    # 2) tokenize
    cfg = LxmertConfig(**DIMS[args.arch], visual_feat_dim=feats.shape[-1])
    tok = build_tokenizer("bert", C.MODEL_DIR_DICT.get("lxmert"), 20, cfg.vocab_size)
    enc = tok([args.text])

    # 3) model forward
    model = LxmertClassifier(cfg, args.num_labels)
    init_lxmert_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    def on_device(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    tt = enc.get("token_type_ids", np.zeros_like(enc["ids"]))
    with torch.inference_mode():
        out = model(on_device(enc["ids"]), on_device(enc["mask"]), on_device(tt),
                    on_device(feats), on_device(boxes))
        probs = torch.softmax(out["out_cls"].float(), dim=-1)[0].cpu().numpy()
    logger.info("text: %r", args.text)
    logger.info("probabilities: %s", probs)
    logger.info("prediction: class %d", int(np.argmax(probs)))
    return probs


if __name__ == "__main__":
    main()
