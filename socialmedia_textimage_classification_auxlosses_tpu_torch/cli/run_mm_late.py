"""Late-fusion multimodal trainer, the paper's headline run, on CUDA.

Counterpart of the JAX package's ``cli/run_mm_late.py``, with the same
flags plus ``--device``, and the same artifacts under the same names
(``{txt}-{img}-{fusion}_task{t}_seed{s}_{loss_str}_{N}`` +
``metrics_val.csv`` / ``metrics_test.csv`` / ``net.pth`` / ``preds.csv``,
and ``preds_lm.csv`` / ``metrics_lm.csv`` under ``--load_saved_model``):

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.run_mm_late \\
        --txt_model_name bernice --img_model_name vit --fusion_name attention \\
        --task 3 --epochs 7 --seed 40 --use_clip_loss --use_tim_loss

Every attention of the forward and of the backward launches the port's
hand-written kernels on a CUDA device; ``--device cpu`` runs the plain
versions on the CPU. ``--img_model_name beit`` runs the BEiT tower (its
attention, with the relative position bias, is PyTorch's, as in the JAX
package it is XLA's); ``resnet50|resnet152`` with ``--fusion_name
concat_cnn|xatt`` the CNN fusion model, which trains its ResNet (float32,
BatchNorm statistics in train mode) with the text tower, reads images
resized to 256 and centre-cropped, and takes no ITC/TIM loss (refused at
parse time, as by the JAX runner). The ``net.pth`` artifact is the port's own
``torch.save`` state dict; ``--load_saved_model`` also evaluates a JAX-trained
one (the flax msgpack, unrolled or in the scanned layout). The towers start from the checkpoints in their
``MODEL_DIR_DICT`` directories (``SMTC_BERNICE_DIR``, ``SMTC_VIT_DIR``, ...)
when those hold one, and ``--import_reference_ckpt`` loads a reference-trained
``MM_Model`` state dict over the whole model (AdamW starts afresh after it).
``--extract_features`` writes ``features.npz`` (the fusion head's
``mm_features`` of the test split, its labels and data ids) and
``--eval_txt_test`` evaluates the text-only MIC set with the empty image
(``preds_txt.csv``, ``metrics_txt.csv``). The run-control flags
(``--steps_per_dispatch``, ``--ckpt_every`` into ``{stem}ckpt/``,
``--resume``, ``--profile``, ``--remat``) act as in the JAX runner, and so
do ``--opt_impl lazy_emb`` (the word table's row-sparse AdamW, its state in
the checkpoints), ``--cache_vision`` (the frozen transformer tower's
features computed once per image; a CNN tower warns and runs uncached) and
``--tim_reuse_text`` (the TIM rows gathered from the first text pass in
training too), ``--bucket_seq`` and ``--bucket_group`` (``data/pipeline.py``:
each batch's text sliced to its bucket; under ``--steps_per_dispatch`` one
CUDA graph per width). What the
port lacks raises ``SystemExit`` (``cli/_common.py::check_training_supported``,
and here ``--quantize``).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import config as C
from ..train.checkpoint import load_params
from ..train.loop import Trainer
from ..train.metrics import compute_metrics
from ..utils.logging import get_logger
from ._build import (build_mm_late_train_setup, check_mm_late_supported,
                     enable_vision_cache, import_reference_checkpoint)
from ._common import (add_common_args, artifact_stem, check_training_supported,
                      resolve_device, results_dir_for, run_control, save_metrics_csv,
                      save_predictions_csv, seed_everything, seq_buckets_from)

logger = get_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="run late fusion models")
    parser.add_argument("--txt_model_name", type=str,
                        choices=["bert", "bernice", "bertweet", "roberta"],
                        help="model name")
    parser.add_argument("--img_model_name", type=str,
                        choices=["vit", "beit", "deit", "resnet50", "resnet152"],
                        help="model name")
    parser.add_argument("--fusion_name", type=str,
                        choices=["xatt", "concat", "attention", "concat_cnn",
                                 "aspect-att", "gmu"],
                        help="fusion method")
    parser.add_argument("--use_iadds_loss", action="store_true",
                        help="use image-adds loss")
    parser.add_argument("--beta_iadds", type=float, default=0.1,
                        help="hyperparameter for iadds loss")
    parser.add_argument("--nsamples", type=int, default=-1,
                        help="number of training samples")
    parser.add_argument("--eval_txt_test", action="store_true",
                        help="eval txt test")
    parser.add_argument("--load_saved_model", action="store_true",
                        help="load saved model")
    parser.add_argument("--quantize", type=str, default=None, choices=["w8"],
                        help="(not ported) weight-only int8 serving")
    parser.add_argument("--import_reference_ckpt", type=str, default=None,
                        help="reference-trained MM_Model state dict (torch.save) to "
                             "import before training")
    parser.add_argument("--extract_features", action="store_true",
                        help="dump fused mm_features")
    add_common_args(parser, multimodal=True)
    args = parser.parse_args(argv)
    if args.img_model_name in ("resnet50", "resnet152") and (
            args.use_clip_loss or args.use_tim_loss):
        parser.error("--use_clip_loss/--use_tim_loss require a transformer "
                     "image tower (vit/beit/deit); the CNN fusion model has "
                     "no image-text projection heads")
    return args


def check_supported(args) -> None:
    check_training_supported(args)
    if args.quantize:
        raise SystemExit("--quantize is not ported to PyTorch yet")
    if args.import_reference_ckpt and args.img_model_name in ("resnet50", "resnet152"):
        raise SystemExit("--import_reference_ckpt takes a transformer image tower: the "
                         "reference's MM_Model has no ResNet fusion path")
    check_mm_late_supported(args)


def main(argv=None, on_step=None, keep_grads=False):
    """Train (or, with ``--load_saved_model``, evaluate) and write the
    artifacts. ``on_step`` is handed to the ``Trainer``; with ``keep_grads``
    the train step keeps the last step's gradients. Returns the ``Trainer``
    and the setup, for callers that inspect the run."""
    args = parse_args(argv)
    check_supported(args)
    device = resolve_device(args.device)
    generator = seed_everything(args.seed)
    results_dir = results_dir_for(C.results_dir_mm_late, args.testing)
    logger.info(
        "Model: %s-%s, Task: %s, Fusion: %s, Testing: %s, PP Features: %s, "
        "ITC Loss: %s, TIM Loss: %s, beta_itc: %s, beta_itm: %s, NSamples: %s, "
        "seed: %s, device: %s, prng_impl: %s (torch.Generator draws)",
        args.txt_model_name, args.img_model_name, args.task, args.fusion_name,
        args.testing, args.use_saved_features, args.use_clip_loss,
        args.use_tim_loss, args.beta_itc, args.beta_itm, args.nsamples,
        args.seed, device, args.prng_impl)

    cfg = C.Config(args)
    cfg.use_iadds_loss = args.use_iadds_loss
    cfg.beta_iadds = args.beta_iadds if args.use_iadds_loss else None
    setup = build_mm_late_train_setup(args, cfg, device, generator, keep_grads=keep_grads)
    if args.import_reference_ckpt:
        import_reference_checkpoint(setup.model, args)
        setup.optimizer.reset()
        if setup.train_step.lazy is not None:
            setup.train_step.lazy.reset()
    if args.cache_vision:
        if args.img_model_name in ("resnet50", "resnet152"):
            logger.warning("--cache_vision requires a (frozen) transformer vision tower; "
                           "ignoring for the CNN path")
        else:
            enable_vision_cache(setup, args)

    stem = artifact_stem(args, cfg)
    model_path = (results_dir + stem + "net.pth"
                  if (args.save_model or args.load_saved_model) else None)
    trainer = Trainer(setup.train_step, setup.eval_step, setup.model, device,
                      seed=args.seed, multilabel=cfg.multilabel,
                      num_labels=cfg.num_labels, metric_names=C.metric_names,
                      log_every=args.log_every, log_jsonl=args.log_jsonl,
                      on_step=on_step,
                      **run_control(args, setup, results_dir + stem + "ckpt"))

    if not args.load_saved_model:
        logger.info("Training")
        trainer.fit(setup.pipes["train"], setup.pipes["val"], args.epochs,
                    te_pipe=setup.pipes["test"],
                    val_filename=results_dir + stem + "metrics_val.csv",
                    te_filename=results_dir + stem + "metrics_test.csv",
                    model_path=model_path)
        if args.save_preds:
            path = results_dir + stem + "preds.csv"
            save_predictions_csv(trainer.evaluate(setup.pipes["test"]), path)
            logger.info("%s saved", path)
        if args.extract_features:
            res = trainer.evaluate(setup.pipes["test"], collect_features=True,
                                   feature_step=setup.feature_step)
            np.savez(results_dir + stem + "features.npz", features=res["features"],
                     labels=res["labels"], data_id=res["data_id"])
            logger.info("%s saved", results_dir + stem + "features.npz")
        if args.eval_txt_test:
            logger.info("Evaluate and compute metrics (txt test)")
            predictions = trainer.evaluate(_txt_test_pipe(args, cfg, setup))
            metrics = compute_metrics(predictions, cfg.num_labels)
            save_predictions_csv(predictions, results_dir + stem + "preds_txt.csv")
            save_metrics_csv(metrics, results_dir + stem + "metrics_txt.csv")
    else:
        from ..utils.cast import cast_params_for_eval

        load_params(model_path, setup.model)
        logger.info("model loaded")
        cast_params_for_eval(setup.model, args.dtype)
        predictions = trainer.evaluate(setup.pipes["test"])
        save_predictions_csv(predictions, results_dir + stem + "preds_lm.csv")
        metrics = compute_metrics(predictions, cfg.num_labels, multilabel=cfg.multilabel)
        save_metrics_csv(metrics, results_dir + stem + "metrics_lm.csv")
        logger.info("%s saved", results_dir + stem + "metrics_lm.csv")
    logger.info("Done!")
    return trainer, setup


def _txt_test_pipe(args, cfg, setup):
    """The MIC text-only eval set (``C.TDATA5``) with the empty image
    (``C.EMPTY_IMG``) for every post, at the test split's image size."""
    from ..data.pipeline import EmptyImageSource, PipelineConfig, SplitPipeline
    from ..data.prep import prepare_text_data

    size = setup.pipes["test"].cfg.image_size
    return SplitPipeline(
        prepare_text_data(C.TDATA5, num_labels=cfg.num_labels, testing=args.testing),
        PipelineConfig(batch_size=cfg.batch_size, max_length=cfg.max_length,
                       image_size=size, seq_buckets=seq_buckets_from(args)),
        tokenizer=setup.tokenizer, image_source=EmptyImageSource(C.EMPTY_IMG, size))


if __name__ == "__main__":
    main()
