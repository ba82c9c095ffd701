"""Text-only trainer on CUDA.

Counterpart of the JAX package's ``cli/run_txt.py``, with the same flags
plus ``--device``, and the same artifacts under the same names
(``{model}_task{t}_seed{s}`` + ``_metrics_val.csv`` / ``_metrics_test.csv``,
``_net.pth`` under ``--save_model``, ``_preds.csv`` under ``--save_preds``,
``_preds_txt.csv`` / ``_metrics_txt.csv`` under ``--eval_txt_test``;
checkpoints in ``{model}_task{t}_seed{s}_ckpt/``):

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.run_txt \\
        --model_name bernice --task 3 --epochs 2 --seed 30

The model is ``models/text.py::TextClassifier``: the tower of
``--model_name`` (bert, bernice, bertweet, roberta) with the CLS head, or
for roberta the pooled head; ``--freeze`` keeps the tower out of AdamW.
Every attention launches the port's kernels on a CUDA device; ``--device
cpu`` runs the plain versions on the CPU. The tower starts from the
checkpoint of its ``MODEL_DIR_DICT`` directory when that holds one. The
run-control flags act as in the other runners; the flags of
``cli/_common.py::check_training_supported`` raise ``SystemExit``.
"""

from __future__ import annotations

import argparse

from ..core import config as C
from ..data.pipeline import PipelineConfig, SplitPipeline
from ..data.prep import prepare_text_data
from ..train.loop import Trainer
from ..train.metrics import compute_metrics
from ..utils.logging import get_logger
from ._build import build_text_setup
from ._common import (add_common_args, check_training_supported, resolve_device,
                      results_dir_for, run_control, save_metrics_csv, save_predictions_csv,
                      seed_everything, seq_buckets_from)

logger = get_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="run text-only models")
    parser.add_argument("--model_name", type=str,
                        choices=["bert", "bernice", "bertweet", "roberta"],
                        help="model name")
    parser.add_argument("--eval_txt_test", action="store_true", help="eval txt test")
    parser.add_argument("--freeze", action="store_true", help="freeze the tower")
    add_common_args(parser)
    return parser.parse_args(argv)


def main(argv=None, on_step=None, keep_grads=False):
    """Train, write the artifacts, and with ``--eval_txt_test`` evaluate the
    text-only MIC set. ``on_step`` is handed to the ``Trainer``; with
    ``keep_grads`` the train step keeps the last step's gradients. Returns
    the ``Trainer`` and the setup, for callers that inspect the run."""
    args = parse_args(argv)
    check_training_supported(args)
    device = resolve_device(args.device)
    generator = seed_everything(args.seed)
    results_dir = results_dir_for(C.results_dir_txt, args.testing)
    logger.info("Model: %s, Task: %s, Epochs: %s, LC:%s, seed: %s, device: %s",
                args.model_name, args.task, args.epochs, args.use_loss_correction,
                args.seed, device)

    cfg = C.Config(args)
    cfg.use_loss_correction = args.use_loss_correction
    setup = build_text_setup(args, cfg, device, generator, freeze=args.freeze,
                             keep_grads=keep_grads)

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

    if args.eval_txt_test:
        pipe = SplitPipeline(
            prepare_text_data(C.TDATA5, num_labels=cfg.num_labels, testing=args.testing),
            PipelineConfig(batch_size=cfg.batch_size, max_length=cfg.max_length,
                           seq_buckets=seq_buckets_from(args)),
            tokenizer=setup.tokenizer)
        predictions = trainer.evaluate(pipe)
        metrics = compute_metrics(predictions, cfg.num_labels)
        save_predictions_csv(predictions, results_dir + stem + "_preds_txt.csv")
        save_metrics_csv(metrics, results_dir + stem + "_metrics_txt.csv")
    logger.info("Done!")
    return trainer, setup


if __name__ == "__main__":
    main()
