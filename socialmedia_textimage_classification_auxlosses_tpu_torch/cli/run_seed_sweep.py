"""Multi-seed late-fusion sweep: the paper's N-seeds-per-config protocol as
one seed-stacked run (``train/ensemble.py``), on CUDA.

Counterpart of the JAX package's ``cli/run_seed_sweep.py``, with the same
flags plus ``--device``. It stands for N invocations of ``run_mm_late``
that differ only in ``--seed``, and writes each seed's artifacts under the
names that run writes (``...seed{s}_...metrics_val.csv`` /
``metrics_test.csv``, ``preds.csv``, ``net.pth``). By default every seed has
its own data subsample and shuffle stream and its own generators, as its
separate run has; ``--shared_data`` gives all seeds the first seed's stream
(one data stream; the per-seed variance is understated, and a warning says
so):

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.run_seed_sweep \\
        --txt_model_name bernice --img_model_name vit --fusion_name attention \\
        --task 2 --seeds 30,40,50 --epochs 7 --use_clip_loss --use_tim_loss

Each seed's model is built as its run builds it (init from its seed, then
the pretrained towers of ``MODEL_DIR_DICT``) and the S models are stacked
(``models/encoder.py::stack_seed_models``). Under ``--attn_impl auto`` every
SDPA kernel launch covers the S seeds' rows; under ``fused`` the block
kernels run once per seed. Each seed trains with its own class weights (the
JAX sweep applies the first seed's to all; they differ only where the
subsamples do). ``--steps_per_dispatch`` replays CUDA graphs of the stacked
step; ``--tim_reuse_text`` acts as in ``run_mm_late``. What the sweep does
not carry raises ``SystemExit``: the single-run flags ``--ckpt_every``,
``--resume``, ``--profile``, ``--log_jsonl``, ``--opt_impl lazy_emb`` and
``--cache_vision`` (the JAX sweep takes both and silently drops them: its
step never trains a lazily-updated word table, and it never caches),
``--bucket_seq`` without ``--shared_data`` (the JAX sweep stacks each
seed's batch sliced to its own bucket, and fails when two differ), and
what ``run_mm_late`` refuses. Under ``--shared_data`` every seed reads one
stream, so a step has one width: ``--bucket_seq`` and ``--bucket_group``
act as in ``run_mm_late``. The BEiT tower is stacked like the others, its
relative-position tables too (``models/beit.py``).
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from ..core import config as C
from ..models.encoder import stack_seed_models
from ..train.checkpoint import save_params
from ..train.ensemble import EnsembleTrainer
from ..train.optim import vision_frozen
from ..train.steps import EvalStep, TrainStep, make_eval_many, make_train_many
from ..utils.logging import get_logger
from ._build import (TrainSetup, build_mm_late_parts, build_optimizer, check_mm_late_supported,
                     freeze_vision, loss_cfg_from, mm_late_forward)
from ._common import (add_common_args, artifact_stem, check_training_supported, resolve_device,
                      results_dir_for, save_predictions_csv, seed_everything)

logger = get_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="seed-stacked multi-seed late-fusion sweep")
    parser.add_argument("--txt_model_name", type=str,
                        choices=["bert", "bernice", "bertweet", "roberta"])
    parser.add_argument("--img_model_name", type=str, choices=["vit", "beit", "deit"])
    parser.add_argument("--fusion_name", type=str,
                        choices=["concat", "attention", "aspect-att", "gmu"])
    parser.add_argument("--seeds", type=str, default="30,40,50",
                        help="comma-separated seeds trained simultaneously")
    parser.add_argument("--nsamples", type=int, default=-1)
    parser.add_argument("--shared_data", action="store_true",
                        help="all seeds share ONE subsample/shuffle stream (the first "
                             "seed's). Cheaper, but deviates from the reference's "
                             "N-independent-runs protocol: only init/dropout/ITM draws "
                             "vary, so per-seed variance is understated")
    add_common_args(parser, multimodal=True)
    return parser.parse_args(argv)


def check_supported(args) -> None:
    check_training_supported(args)
    single_run = [("--ckpt_every", args.ckpt_every), ("--resume", args.resume),
                  ("--profile", args.profile), ("--log_jsonl", args.log_jsonl)]
    for flag, asked in single_run:
        if asked:
            raise SystemExit(f"{flag} is a single-run flag the seed sweep does not carry "
                             "(nor does the JAX package's); run the seeds with run_mm_late")
    check_mm_late_supported(args)
    # the JAX sweep takes both flags and drops them: its EnsembleTrainer builds
    # the step without the lazy config, so the word table (labelled
    # set_to_zero) never trains, and it never enables the vision cache
    if args.opt_impl == "lazy_emb":
        raise SystemExit("--opt_impl lazy_emb is not carried by the seed sweep: the JAX "
                         "sweep hands its step an optimizer that freezes the word table "
                         "without the row update, so it never trains the table; run the "
                         "seeds with run_mm_late")
    if args.cache_vision:
        raise SystemExit("--cache_vision is not carried by the seed sweep: the JAX sweep "
                         "ignores it (it never wraps its pipes in the cache); run the "
                         "seeds with run_mm_late")
    # the JAX sweep stacks the seeds' batches of one step (train/ensemble.py
    # _stack_batches): each is sliced to its own bucket, so two seeds whose
    # batches fall in different buckets stop it with a shape error
    if args.bucket_seq and not args.shared_data:
        raise SystemExit("--bucket_seq without --shared_data is not carried by the seed "
                         "sweep: each seed's batch of a step is sliced to its own bucket, "
                         "and the JAX sweep fails with a shape error when two seeds' "
                         "buckets differ; pass --shared_data (one stream, one width a "
                         "step) or run the seeds with run_mm_late")


def build_seed_setups(args, seeds):
    """One ``build_mm_late_parts`` per seed, each as that seed's separate
    ``run_mm_late`` builds it: the global generators seeded with the seed,
    the model initialised from it (then the pretrained towers), its own data
    subsample and pipelines."""
    parts = []
    for s in seeds:
        a = copy.deepcopy(args)
        a.seed = s
        parts.append(build_mm_late_parts(a, C.Config(a), seed_everything(s)))
    return parts


def build_sweep_setup(args, cfg, parts, device, independent: bool = True,
                      keep_grads: bool = False) -> TrainSetup:
    """The seed-stacked model of ``parts`` on ``device`` with AdamW and the
    seed-stacked steps; ``pipes`` holds per split one pipeline per seed
    (independent data) or the first seed's."""
    seeds = len(parts)
    model = stack_seed_models([p.base.model for p in parts])
    for p in parts[1:]:
        p.base.model = None  # stacked: their own copies are not needed
    model = model.to(device)
    freeze_vision(model)
    forward_fn = mm_late_forward(model, args, cfg, parts[0].base.image_norm)
    optimizer, _ = build_optimizer(model, args, cfg, vision_frozen)  # exact: lazy is refused
    weights = [p.class_weights for p in (parts if independent else parts[:1] * seeds)]
    if independent and weights[0] is not None and not all(
            np.allclose(w, weights[0]) for w in weights[1:]):
        logger.warning("per-seed class weights differ (subsample-dependent under --testing); "
                       "each seed trains with its own, as its separate run does (the JAX "
                       "sweep applies the first seed's to every seed)")
    cw = None if weights[0] is None else [torch.tensor(w, device=device) for w in weights]
    loss_cfg = loss_cfg_from(cfg)
    pipes = {name: ([p.pipes[name] for p in parts] if independent else parts[0].pipes[name])
             for name in ("train", "val", "test")}
    logger.info("seed-stacked model: %d seeds, %d parameters (trainable %d)", seeds,
                sum(p.numel() for p in model.parameters()),
                sum(p.numel() for _, p in optimizer.params))
    return TrainSetup(
        model=model, device=device, optimizer=optimizer, pipes=pipes,
        train_step=TrainStep(model, forward_fn, loss_cfg, optimizer, cw,
                             keep_grads=keep_grads, seeds=seeds),
        eval_step=EvalStep(model, forward_fn, loss_cfg, cw, seeds=seeds),
        tokenizer=parts[0].base.tokenizer)


def main(argv=None, on_step=None, keep_grads=False):
    """Train the seeds together and write each seed's artifacts. ``on_step``
    is handed to the ``EnsembleTrainer``; with ``keep_grads`` the step keeps
    the last step's gradients. Returns the trainer and the setup."""
    args = parse_args(argv)
    check_supported(args)
    seeds = [int(s) for s in args.seeds.split(",")]
    args.seed = seeds[0]
    device = resolve_device(args.device)
    results_dir = results_dir_for(C.results_dir_mm_late, args.testing)
    independent = not args.shared_data
    logger.info("Seed sweep %s (%s data): %s-%s %s task %s, device %s", seeds,
                "independent" if independent else "SHARED", args.txt_model_name,
                args.img_model_name, args.fusion_name, args.task, device)
    if not independent:
        logger.warning("--shared_data: all seeds share seed %d's subsample/shuffle stream; "
                       "this deviates from the reference's N-independent-runs protocol and "
                       "UNDERSTATES per-seed variance; drop the flag for the paper's "
                       "semantics", seeds[0])
    cfg = C.Config(args)
    setup = build_sweep_setup(args, cfg, build_seed_setups(args, seeds), device,
                              independent, keep_grads=keep_grads)
    seed_everything(args.seed)
    trainer = EnsembleTrainer(
        setup.train_step, setup.eval_step, setup.model, device, seeds,
        multilabel=cfg.multilabel, num_labels=cfg.num_labels, metric_names=C.metric_names,
        log_every=args.log_every, independent_data=independent, on_step=on_step,
        train_many=make_train_many(setup.train_step),
        eval_many=make_eval_many(setup.eval_step),
        steps_per_dispatch=args.steps_per_dispatch)

    fmt_args = copy.copy(args)
    fmt_args.seed = "{seed}"
    stem_fmt = results_dir + artifact_stem(fmt_args, cfg)
    trainer.fit(setup.pipes["train"], setup.pipes["val"], args.epochs,
                te_pipes=setup.pipes["test"], val_filename_fmt=stem_fmt + "metrics_val.csv",
                te_filename_fmt=stem_fmt + "metrics_test.csv")
    if args.save_preds:
        res = trainer.evaluate(setup.pipes["test"])
        for s in seeds:
            save_predictions_csv(res[s], stem_fmt.format(seed=s) + "preds.csv")
    if args.save_model:
        for s in seeds:
            save_params(stem_fmt.format(seed=s) + "net.pth", trainer.params_for_seed(s))
    logger.info("Done!")
    return trainer, setup


if __name__ == "__main__":
    main()
