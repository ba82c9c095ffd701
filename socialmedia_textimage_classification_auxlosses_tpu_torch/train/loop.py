"""The training loop.

Counterpart of the JAX package's ``train/loop.py`` ``Trainer``, with its
observable contract:

* per-epoch val (and test) eval;
* metric x epoch CSVs written at every second epoch and at the last
  (``agg_metrics_val`` tables, written with ``csv``);
* the eval result dict: data_id, loss (mean of per-batch losses),
  predictions, labels, confusion counts;
* ``--log_every`` step logs and ``--log_jsonl`` records;
* the final parameter save to the artifact name.

Batches are visited in the order of ``np.random.RandomState(seed)``, as in
the JAX package. Dropout and the ITM swap draw from one ``torch.Generator``
on the device seeded with ``seed``; each eval starts a generator seeded with
``seed + 10_000_000``, so every eval draws the same swaps. ``on_step``, when
given, is called after every train step with (global step, metrics); the
mid-training checkpoints, preemption handling, profiler traces and chunked
dispatch of the JAX trainer are not ported.
"""

from __future__ import annotations

import csv
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.logging import get_logger
from .metrics import agg_metrics_val

logger = get_logger(__name__)


def write_table_csv(table: Dict[str, List], path: str) -> None:
    """A column table (``{"metric": [...], "epoch-1": [...]}``) as CSV, the
    columns in their order, as pandas' ``to_csv(index=False)`` writes it."""
    cols = list(table)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for row in zip(*(table[c] for c in cols)):
            w.writerow(row)


class Trainer:
    def __init__(self, train_step, eval_step, model, device, seed: int = 30,
                 multilabel: bool = False, num_labels: int = 2,
                 metric_names: Optional[List[str]] = None, log_every: int = 10,
                 log_jsonl: Optional[str] = None,
                 on_step: Optional[Callable] = None):
        self.train_step = train_step
        self.eval_step = eval_step
        self.model = model
        self.device = torch.device(device)
        self.seed = seed
        self.host_rng = np.random.RandomState(seed)
        self.gen = torch.Generator(self.device).manual_seed(seed)
        self.multilabel = multilabel
        self.num_labels = num_labels
        self.metric_names = metric_names or []
        self.log_every = log_every
        self.log_jsonl = log_jsonl
        self.on_step = on_step
        self.global_step = 0

    def _write_jsonl(self, record: Dict):
        if self.log_jsonl:
            with open(self.log_jsonl, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _epoch_eval(self, val_pipe, te_pipe, epoch, epochs, res_val, res_te,
                    val_filename, te_filename):
        for pipe, res, filename in ((val_pipe, res_val, val_filename),
                                    (te_pipe, res_te, te_filename)):
            if pipe is None:
                continue
            r = self.evaluate(pipe)
            r["epoch"] = epoch
            res.append(r)
            if filename and (epoch % 2 == 0 or epoch == epochs - 1):
                write_table_csv(agg_metrics_val(res, self.metric_names, self.num_labels,
                                                self.multilabel), filename)
                logger.info("%s saved!", filename)

    def fit(self, train_pipe, val_pipe, epochs: int, te_pipe=None,
            val_filename: Optional[str] = None, te_filename: Optional[str] = None,
            model_path: Optional[str] = None):
        res_val: List[Dict] = []
        res_te: List[Dict] = []
        for epoch in range(epochs):
            logger.info("Epoch: %d", epoch + 1)
            t_epoch = time.perf_counter()
            seen = 0
            for i, batch in enumerate(train_pipe.device_iter(
                    self.device, shuffle=True, rng=self.host_rng)):
                metrics = self.train_step(batch, self.gen)
                self.global_step += 1
                seen += int(train_pipe.cfg.batch_size)
                if self.on_step is not None:
                    self.on_step(self.global_step, metrics)
                if i % self.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    acc = 100.0 * m["correct"] / max(m["n"], 1.0)
                    logger.info("step %d loss %.4f acc %.2f%%", self.global_step,
                                m["loss"], acc)
                    self._write_jsonl({"kind": "train", "step": self.global_step,
                                       "epoch": epoch, "accuracy": acc,
                                       **{k: v for k, v in m.items()
                                          if k not in ("correct", "n")}})
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t_epoch
            nb = train_pipe.num_batches
            logger.info("epoch %d: %.1fs, %.2f steps/s, %.1f posts/s",
                        epoch + 1, dt, nb / dt, seen / dt)
            self._write_jsonl({"kind": "epoch", "epoch": epoch, "seconds": dt,
                               "steps_per_sec": nb / dt, "posts_per_sec": seen / dt})
            self._epoch_eval(val_pipe, te_pipe, epoch, epochs, res_val, res_te,
                             val_filename, te_filename)
        if model_path:
            from .checkpoint import save_params

            save_params(model_path, self.model)
        return res_val, res_te

    def evaluate(self, pipe) -> Dict:
        """The eval result: per-batch mean loss, stacked predictions,
        labels and data ids of the valid rows, summed confusion counts."""
        gen = torch.Generator(self.device).manual_seed(self.seed + 10_000_000)
        losses, preds, targets, data_ids = [], [], [], []
        cm = None
        correct = n = 0.0
        for batch in pipe.device_iter(self.device, shuffle=False):
            out = self.eval_step(batch, gen)
            valid = batch["valid"].cpu().numpy().astype(bool)
            losses.append(float(out["loss"]))
            preds.append(out["predictions"].cpu().numpy()[valid])
            targets.append(out["targets"].cpu().numpy()[valid])
            data_ids.append(np.asarray(batch["data_id"])[valid])
            c = out["cm"].cpu().numpy()
            cm = c if cm is None else cm + c
            correct += float(out["correct"])
            n += float(out["n"])
        eval_loss = float(np.mean(losses)) if losses else float("nan")
        logger.info("loss: %.4f acc: %.4f", eval_loss, 100.0 * correct / max(n, 1.0))
        return {
            "data_id": np.concatenate(data_ids) if data_ids else np.array([]),
            "loss": eval_loss,
            "predictions": np.concatenate(preds) if preds else np.array([]),
            "labels": np.concatenate(targets) if targets else np.array([]),
            "cm": cm,
        }
