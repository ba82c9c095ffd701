"""Early-fusion trainer (ViLT, MMBT, LXMERT) on CUDA.

Counterpart of the JAX package's ``cli/run_mm_early.py``, with the same
flags plus ``--device``, and the same artifacts under the same names
(``{model}_task{t}_seed{s}_{loss_str}_`` + ``metrics_val.csv`` /
``metrics_test.csv`` / ``net.pth``, and ``preds.csv`` / ``metrics.csv``
under ``--evaltest``), under ``results_dir_mm_early`` (MMBT: the reference's
``results_dir_mmbt``):

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.run_mm_early \
        --model vilt --task 3 --vilt_exact_resize --use_clip_loss --use_tim_loss

Every attention, forward and backward, launches the port's hand-written
kernels on a CUDA device (ViLT at L = 402 under ``--vilt_exact_resize``, the
query-tiled backward; MMBT's joint sequence of 132; LXMERT's language,
vision and cross attentions at 128 and 36); ``--device cpu`` runs the plain
versions on the CPU. The ``net.pth`` artifact is the port's own
``torch.save`` state dict. Each model starts from the pretrained checkpoint
its ``MODEL_DIR_DICT`` entry holds, if any (``cli/_build_early.py``); LXMERT
reads its ROI features from ``<data>/cache/{task}_roi``, the reference's
dumps or, without either, grid features it builds there.
``--import_reference_ckpt`` loads a reference-trained ``ViLT`` or ``Lxmert``
state dict over the whole model (AdamW starts afresh after it); MMBT has no
reference format and refuses it. The run-control flags
(``--steps_per_dispatch``, ``--ckpt_every`` into ``{stem}ckpt/``,
``--resume``, ``--profile``, ``--remat`` but for LXMERT) act as in the JAX
runner. The flags of ``cli/_common.py::check_training_supported`` raise
``SystemExit``.
"""

from __future__ import annotations

import argparse

from ..core import config as C
from ..train.loop import Trainer
from ..train.metrics import compute_metrics
from ..utils.logging import get_logger
from ._build_early import (build_mm_early_train_setup, check_mm_early_supported,
                           import_reference_checkpoint)
from ._common import (add_common_args, artifact_stem, check_training_supported,
                      resolve_device, results_dir_for, run_control, save_metrics_csv,
                      save_predictions_csv, seed_everything)

logger = get_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="run early fusion models")
    parser.add_argument("--model", type=str, choices=["vilt", "lxmert", "mmbt"],
                        help="model name")
    parser.add_argument("--evaltest", action="store_true", help="eval test")
    parser.add_argument("--import_reference_ckpt", type=str, default=None,
                        help="reference-trained ViLT or Lxmert state dict (torch.save) "
                             "to import before training")
    parser.add_argument("--vilt_exact_resize", action="store_true",
                        help="ViltProcessor geometry per sample: aspect-preserving "
                             "resize onto a fixed masked 608-px canvas (402 joint "
                             "tokens) with the position grid interpolated per "
                             "sample; default: a fixed square (185 tokens)")
    parser.add_argument("--tim_two_pass", action="store_true",
                        help="run the TIM rows as a second backbone pass instead "
                             "of one 2B-row pass (the same math; only the dropout "
                             "draws differ)")
    add_common_args(parser, multimodal=True)
    return parser.parse_args(argv)


def check_supported(args) -> None:
    check_training_supported(args)
    check_mm_early_supported(args)


def main(argv=None, on_step=None, keep_grads=False):
    """Train, write the artifacts and, with ``--evaltest``, evaluate the
    test split. ``on_step`` is handed to the ``Trainer``; with
    ``keep_grads`` the train step keeps the last step's gradients. Returns
    the ``Trainer`` and the setup, for callers that inspect the run."""
    args = parse_args(argv)
    check_supported(args)
    device = resolve_device(args.device)
    generator = seed_everything(args.seed)
    # MMBT artifacts land in the reference's own directory
    results_dir = results_dir_for(
        C.results_dir_mmbt if args.model == "mmbt" else C.results_dir_mm_early, args.testing)
    logger.info(
        "Model: %s, Task: %s, Epochs: %s, ITC loss: %s, TIM loss: %s, beta_itc: %s, "
        "beta_itm: %s, seed: %s, exact resize: %s, device: %s", args.model, args.task,
        args.epochs, args.use_clip_loss, args.use_tim_loss, args.beta_itc, args.beta_itm,
        args.seed, args.vilt_exact_resize, device)

    cfg = C.Config(args, model_name=args.model)
    setup = build_mm_early_train_setup(args, cfg, device, generator, keep_grads=keep_grads)
    if args.import_reference_ckpt:
        import_reference_checkpoint(setup.model, args)
        setup.optimizer.reset()
    stem = artifact_stem(args, cfg, family=args.model)
    trainer = Trainer(setup.train_step, setup.eval_step, setup.model, device,
                      seed=args.seed, multilabel=cfg.multilabel,
                      num_labels=cfg.num_labels, metric_names=C.metric_names,
                      log_every=args.log_every, log_jsonl=args.log_jsonl,
                      on_step=on_step,
                      **run_control(args, setup, results_dir + stem + "ckpt"))
    logger.info("Training")
    trainer.fit(setup.pipes["train"], setup.pipes["val"], args.epochs,
                te_pipe=setup.pipes["test"],
                val_filename=results_dir + stem + "metrics_val.csv",
                te_filename=results_dir + stem + "metrics_test.csv",
                model_path=results_dir + stem + "net.pth" if args.save_model else None)
    if args.evaltest:
        predictions = trainer.evaluate(setup.pipes["test"])
        metrics = compute_metrics(predictions, cfg.num_labels, multilabel=cfg.multilabel)
        print(metrics)
        if not args.testing:
            save_predictions_csv(predictions, results_dir + stem + "preds.csv")
            save_metrics_csv(metrics, results_dir + stem + "metrics.csv")
    logger.info("Done!")
    return trainer, setup


if __name__ == "__main__":
    main()
