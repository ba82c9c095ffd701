"""Image-only trainer on CUDA: ViT, BEiT, DeiT and ResNet-50/152.

Counterpart of the JAX package's ``cli/run_img.py``, with the same flags
plus ``--device``, and the same artifacts under the same names
(``{model}_task{t}_seed{s}`` + ``_metrics_val.csv`` / ``_metrics_test.csv``,
``_net.pth`` under ``--save_model``, ``_preds.csv`` under ``--save_preds``;
checkpoints in ``{model}_task{t}_seed{s}_ckpt/``):

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.run_img \\
        --model_name vit --task 6 --epochs 2

The model is ``models/vision.py``'s classifier of ``--model_name``; the
whole tower trains (``--conv_att``: the attention-CNN over a ResNet trunk;
``--feature_extract``: a ResNet's trunk frozen, only the ``fc`` head
trains, its BatchNorm statistics kept). ViT and DeiT attention launches the
port's kernels on a CUDA device (forward and backward; under
``--attn_impl fused`` the whole-block kernels); BEiT's attention, with its
relative position bias, and the convolutions are PyTorch calls, as in the
JAX package they are XLA's. ``--device cpu`` runs the plain versions on the
CPU. The tower starts from the checkpoint of its ``MODEL_DIR_DICT`` entry
when that holds one (an HF directory, or a torchvision ``.pth`` / ``.npz``
for the ResNets). ``--use_saved_features`` reads the uint8 pixel cache
``<data>/cache/{task}_u8_{size}``. The run-control flags act as in the
other runners; the flags of ``cli/_common.py::check_training_supported``
raise ``SystemExit``.
"""

from __future__ import annotations

import argparse

from ..core import config as C
from ..train.loop import Trainer
from ..utils.logging import get_logger
from ._build import build_image_setup
from ._common import (add_common_args, check_training_supported, resolve_device,
                      results_dir_for, run_control, save_predictions_csv, seed_everything)

logger = get_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="run image-only models")
    parser.add_argument("--model_name", type=str,
                        choices=["vit", "beit", "deit", "resnet50", "resnet152"],
                        help="model name")
    parser.add_argument("--conv_att", action="store_true", help="CNN ATT")
    parser.add_argument("--feature_extract", action="store_true",
                        help="freeze the conv trunk")
    parser.add_argument("--use_saved_features", action="store_true",
                        help="use the uint8 pixel cache")
    add_common_args(parser)
    return parser.parse_args(argv)


def main(argv=None, on_step=None, keep_grads=False):
    """Train and write the artifacts. ``on_step`` is handed to the
    ``Trainer``; with ``keep_grads`` the train step keeps the last step's
    gradients. Returns the ``Trainer`` and the setup, for callers that
    inspect the run."""
    args = parse_args(argv)
    check_training_supported(args)
    device = resolve_device(args.device)
    generator = seed_everything(args.seed)
    results_dir = results_dir_for(C.results_dir_img, args.testing)
    logger.info("Model: %s, Task: %s, feature extract: %s, conv att: %s, Epochs: %s, "
                "seed: %s, device: %s", args.model_name, args.task, args.feature_extract,
                args.conv_att, args.epochs, args.seed, device)

    cfg = C.Config(args)
    setup = build_image_setup(args, cfg, device, generator, keep_grads=keep_grads)

    stem = f"{args.model_name}_task{args.task}_seed{args.seed}"
    trainer = Trainer(setup.train_step, setup.eval_step, setup.model, device,
                      seed=args.seed, multilabel=cfg.multilabel,
                      num_labels=cfg.num_labels, metric_names=C.metric_names,
                      log_every=args.log_every, log_jsonl=args.log_jsonl,
                      on_step=on_step,
                      **run_control(args, setup, results_dir + stem + "_ckpt"))
    logger.info("Training")
    trainer.fit(setup.pipes["train"], setup.pipes["val"], args.epochs,
                te_pipe=setup.pipes["test"],
                val_filename=results_dir + stem + "_metrics_val.csv",
                te_filename=results_dir + stem + "_metrics_test.csv",
                model_path=results_dir + stem + "_net.pth" if args.save_model else None)

    if args.save_preds:
        path = results_dir + stem + "_preds.csv"
        save_predictions_csv(trainer.evaluate(setup.pipes["test"]), path)
        logger.info("%s saved", path)
    logger.info("Done!")
    return trainer, setup


if __name__ == "__main__":
    main()
