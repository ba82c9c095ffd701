"""Multi-seed training: N independent fine-tunes in one seed-stacked step.

Counterpart of the JAX package's ``train/ensemble.py``. The paper's
protocol runs every configuration under several seeds; the JAX package
vmaps its step over a leading seed axis of (params, opt_state, rng). Here
the model's every parameter carries that axis
(``models/encoder.py::stack_seed_models``), the batch holds the S seeds'
rows one after another, and the step (``train/steps.py`` with ``seeds`` =
S) computes each seed's loss on its rows, differentiates their sum once and
steps AdamW over the stacked tensors: the attention kernels see the S·B
rows as their batch, one launch for all seeds.

Each seed draws as its own run (``train/loop.py::Trainer``) draws: its
shuffles from ``np.random.RandomState(seed)``, its dropout masks and TIM
swaps from ``torch.Generator(device).manual_seed(seed)`` and, at every
evaluation, from one reseeded with ``seed + 10_000_000``. So a seed's
trajectory is that of its separate run, up to the order of float sums.

Two data modes:

* **independent** (the default, the reference protocol): every seed has its
  own pipelines (its own ``prepare_data`` subsample and shuffle stream), and
  each step stacks one batch per seed. If the seeds' splits differ in size
  (possible under ``--testing``), each epoch stops at the shortest seed's
  batch count, with a warning.
* **shared** (one pipeline per split): every seed sees the batches of the
  first seed's stream, shuffled by the first seed's host generator; only the
  init, dropout and TIM draws differ.

``--steps_per_dispatch K`` goes through the chunked steps of
``train/steps.py`` (``make_train_many`` with the S generators registered in
the CUDA graph). Per-seed metric CSVs are written as the ``Trainer`` writes
its own, at every second epoch and at the last.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.pipeline import stage_chunks, to_device
from ..models.encoder import params_for_seed
from ..utils.logging import get_logger
from .loop import write_table_csv
from .metrics import agg_metrics_val

logger = get_logger(__name__)


class EnsembleTrainer:
    """The multi-seed twin of ``train.loop.Trainer``: ``fit`` and
    ``evaluate`` return one result per seed, keyed by the seed."""

    def __init__(self, train_step, eval_step, model, device, seeds: List[int],
                 multilabel: bool = False, num_labels: int = 2,
                 metric_names: Optional[List[str]] = None, log_every: int = 10,
                 independent_data: bool = True, on_step: Optional[Callable] = None,
                 train_many: Optional[Callable] = None, eval_many: Optional[Callable] = None,
                 steps_per_dispatch: int = 1):
        self.train_step = train_step
        self.eval_step = eval_step
        self.model = model
        self.device = torch.device(device)
        self.seeds = list(seeds)
        self.multilabel = multilabel
        self.num_labels = num_labels
        self.metric_names = metric_names or []
        self.log_every = log_every
        self.independent = bool(independent_data)
        self.on_step = on_step
        self.train_many = train_many
        self.eval_many = eval_many
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        # what each seed's own Trainer seeds: its shuffles, its device draws
        self.host_rngs = [np.random.RandomState(s) for s in self.seeds]
        self.gens = tuple(torch.Generator(self.device).manual_seed(s) for s in self.seeds)
        self.eval_gens = tuple(torch.Generator(self.device) for _ in self.seeds)
        self.global_step = 0

    # -- batches ---------------------------------------------------------------

    def host_batches(self, pipes, shuffle: bool):
        """Stacked host batches: one batch per seed, concatenated seed-major.
        ``pipes``: one pipeline per seed (independent data) or one for all."""
        s = len(self.seeds)
        if not self.independent:
            rng = self.host_rngs[0] if shuffle else None
            for b in pipes.batches(shuffle=shuffle, rng=rng):
                yield {k: np.concatenate([v] * s) for k, v in b.items()}
            return
        counts = [p.num_batches for p in pipes]
        if len(set(counts)) > 1:
            logger.warning("independent-data sweep: the seeds' splits differ in size "
                           "(batches per seed: %s); each epoch stops at the shortest (%d), "
                           "so the trajectories equal the separate runs only up to that "
                           "step", counts, min(counts))
        rngs = self.host_rngs if shuffle else [None] * s
        for per_seed in zip(*(p.batches(shuffle=shuffle, rng=r) for p, r in zip(pipes, rngs))):
            yield {k: np.concatenate([b[k] for b in per_seed]) for k in per_seed[0]}

    def device_batches(self, pipes, shuffle: bool, k: int):
        """(batches, k_real): single stacked batches on the device for k = 1,
        else chunks of k of them stacked on a new leading axis."""
        if k == 1:
            for b in self.host_batches(pipes, shuffle):
                yield to_device(b, self.device), 1
            return
        yield from stage_chunks(self.host_batches(pipes, shuffle), self.device, k)

    # -- train -----------------------------------------------------------------

    def _fit_epoch(self, train_pipes) -> tuple:
        """One epoch; returns (steps, the last step's per-seed losses)."""
        k = self.steps_per_dispatch if self.train_many is not None else 1
        steps, last = 0, None
        for batches, k_real in self.device_batches(train_pipes, True, k):
            if k == 1:
                metrics = self.train_step(batches, self.gens)
            else:
                metrics = self.train_many(batches, k_real, self.gens)
            prev = self.global_step
            self.global_step += k_real
            steps += k_real
            if self.on_step is not None:
                self.on_step(self.global_step, metrics)
            every = max(self.log_every, 1)
            if prev // every != self.global_step // every:
                losses = metrics["loss"].reshape(-1, len(self.seeds))[-1]
                logger.info("step %d per-seed loss %s", self.global_step,
                            [round(float(x), 4) for x in losses])
            last = metrics["loss"]
        return steps, last

    def fit(self, train_pipes, val_pipes, epochs: int, te_pipes=None,
            val_filename_fmt: Optional[str] = None, te_filename_fmt: Optional[str] = None):
        """``*_fmt``: file names with a ``{seed}`` placeholder. Returns the
        per-seed eval result lists of val and test."""
        res_val: Dict[int, List] = {s: [] for s in self.seeds}
        res_te: Dict[int, List] = {s: [] for s in self.seeds}
        for epoch in range(epochs):
            logger.info("Epoch: %d (seeds %s)", epoch + 1, self.seeds)
            t0 = time.perf_counter()
            steps, last = self._fit_epoch(train_pipes)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            if last is not None:
                losses = last.reshape(-1, len(self.seeds))[-1]
                logger.info("epoch %d: %.1fs, %d steps of %d seeds, per-seed loss %s",
                            epoch + 1, dt, steps, len(self.seeds),
                            [round(float(x), 4) for x in losses])
            for pipes, res, fmt in ((val_pipes, res_val, val_filename_fmt),
                                    (te_pipes, res_te, te_filename_fmt)):
                if pipes is None:
                    continue
                for s, r in self.evaluate(pipes).items():
                    res[s].append(dict(r, epoch=epoch))
                if fmt and (epoch % 2 == 0 or epoch == epochs - 1):
                    for s in self.seeds:
                        write_table_csv(agg_metrics_val(res[s], self.metric_names,
                                                        self.num_labels, self.multilabel),
                                        fmt.format(seed=s))
        return res_val, res_te

    # -- eval ------------------------------------------------------------------

    def evaluate(self, pipes) -> Dict[int, Dict]:
        """Per seed: the eval result of its own ``Trainer.evaluate`` (mean
        per-batch loss, predictions, labels and data ids of the valid rows,
        summed confusion counts)."""
        s = len(self.seeds)
        for seed, g in zip(self.seeds, self.eval_gens):
            g.manual_seed(seed + 10_000_000)
        k = self.steps_per_dispatch if self.eval_many is not None else 1
        acc = {seed: {"losses": [], "preds": [], "targets": [], "ids": [], "cm": None}
               for seed in self.seeds}
        for batches, k_real in self.device_batches(pipes, False, k):
            if k == 1:
                outs = [self.eval_step(batches, self.eval_gens)]
                valid = [batches["valid"]]
                ids = [batches["data_id"]]
            else:
                stacked = self.eval_many(batches, k_real, self.eval_gens)
                outs = [{key: v[j] for key, v in stacked.items()} for j in range(k_real)]
                valid = list(batches["valid"][:k_real])
                ids = list(batches["data_id"][:k_real])
            for out, v, ids_j in zip(outs, valid, ids):
                out = {key: t.cpu().numpy() for key, t in out.items()}
                v = v.cpu().numpy().astype(bool).reshape(s, -1)
                preds, targets = (out[key].reshape(s, -1, *out[key].shape[1:])
                                  for key in ("predictions", "targets"))
                ids_j = np.asarray(ids_j).reshape(s, -1)
                for i, seed in enumerate(self.seeds):
                    a = acc[seed]
                    a["losses"].append(float(out["loss"][i]))
                    a["preds"].append(preds[i][v[i]])
                    a["targets"].append(targets[i][v[i]])
                    a["ids"].append(ids_j[i][v[i]])
                    a["cm"] = out["cm"][i] if a["cm"] is None else a["cm"] + out["cm"][i]
        res = {}
        for seed in self.seeds:
            a = acc[seed]
            res[seed] = {
                "data_id": np.concatenate(a["ids"]) if a["ids"] else np.array([]),
                "loss": float(np.mean(a["losses"])) if a["losses"] else float("nan"),
                "predictions": np.concatenate(a["preds"]) if a["preds"] else np.array([]),
                "labels": np.concatenate(a["targets"]) if a["targets"] else np.array([]),
                "cm": a["cm"],
            }
        logger.info("eval loss per seed %s", {seed: round(r["loss"], 4) for seed, r in res.items()})
        return res

    def params_for_seed(self, seed: int) -> Dict[str, torch.Tensor]:
        """The state dict of ``seed``'s model, as its own run would save it."""
        return params_for_seed(self.model, self.seeds.index(seed))
