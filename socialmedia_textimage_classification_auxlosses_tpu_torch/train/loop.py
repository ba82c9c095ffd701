"""The training loop.

Counterpart of the JAX package's ``train/loop.py`` ``Trainer``, with its
observable contract:

* per-epoch val (and test) eval;
* metric x epoch CSVs written at every second epoch and at the last
  (``agg_metrics_val`` tables, written with ``csv``);
* the eval result dict: data_id, loss (mean of per-batch losses),
  predictions, labels, confusion counts;
* ``--log_every`` step logs and ``--log_jsonl`` records;
* the final parameter save to the artifact name;

and its run control:

* ``--steps_per_dispatch K`` (``train_many`` / ``eval_many`` of
  ``train/steps.py``): the epoch goes in chunks of K batches staged on the
  device together; on a CUDA device each step is a CUDA graph replay. The
  host reads a chunk's metrics once, logs one chunk summary and calls
  ``on_step`` once per chunk. The trajectory is that of K = 1.
* ``--ckpt_every N`` (``checkpointer``, ``train/checkpoint.py``): a
  checkpoint whenever the global step passes a multiple of N (at a chunk's
  end under K > 1); ``--resume`` restores the newest in place and continues
  from its step: the epoch's visit order is drawn again from the saved host
  generator and the steps already taken are skipped, so a resumed run ends
  with the parameters of one that was never stopped.
* SIGTERM, when checkpoints are on, asks for a checkpoint and a clean exit
  at the next step or chunk boundary; a checkpoint that does not commit
  raises.
* ``--profile DIR``: a ``torch.profiler`` trace of the whole fit in DIR.

Batches are visited in the order of ``np.random.RandomState(seed)``, as in
the JAX package. Dropout and the ITM swap draw from one ``torch.Generator``
on the device seeded with ``seed``; every eval reseeds its own generator
with ``seed + 10_000_000``, so every eval draws the same swaps. ``on_step``,
when given, is called with (global step, metrics) after every step, or
under K > 1 after every chunk with each metric as a (k_real,) tensor.
"""

from __future__ import annotations

import csv
import json
import os
import signal
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
                 on_step: Optional[Callable] = None, checkpointer=None,
                 profile_dir: Optional[str] = None, resume: bool = False,
                 train_many: Optional[Callable] = None,
                 eval_many: Optional[Callable] = None, steps_per_dispatch: int = 1):
        self.train_step = train_step
        self.eval_step = eval_step
        self.model = model
        self.device = torch.device(device)
        self.seed = seed
        self.host_rng = np.random.RandomState(seed)
        self.gen = torch.Generator(self.device).manual_seed(seed)
        self.eval_gen = torch.Generator(self.device)
        self.multilabel = multilabel
        self.num_labels = num_labels
        self.metric_names = metric_names or []
        self.log_every = log_every
        self.log_jsonl = log_jsonl
        self.on_step = on_step
        self.checkpointer = checkpointer
        self.profile_dir = profile_dir
        self.resume = resume
        self.train_many = train_many
        self.eval_many = eval_many
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.global_step = 0
        self.start_epoch = 0
        self.skip_steps = 0  # steps of start_epoch a resumed run has taken
        self._epoch_rng = self.host_rng.get_state()  # the host generator at the epoch's start
        self._preempted = False

    def _write_jsonl(self, record: Dict):
        if self.log_jsonl:
            with open(self.log_jsonl, "a") as f:
                f.write(json.dumps(record) + "\n")

    # -- checkpoints ----------------------------------------------------------

    def _state(self, epoch: int, step_in_epoch: int) -> Dict:
        keys, pos, has_gauss, gauss = self._epoch_rng[1:]
        lazy = getattr(self.train_step, "lazy", None)
        return {"model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                "optimizer": self.train_step.optimizer.state_dict(),
                **({"lazy_emb": lazy.state_dict()} if lazy is not None else {}),
                "step": self.global_step, "epoch": epoch, "step_in_epoch": step_in_epoch,
                "gen": self.gen.get_state(),
                "host_rng": {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
                             "has_gauss": int(has_gauss), "gauss": float(gauss)}}

    def _save(self, epoch: int, step_in_epoch: int) -> None:
        self.checkpointer.save(self.global_step, self._state(epoch, step_in_epoch))

    def maybe_resume(self) -> None:
        """Restore the newest checkpoint, if any, in place: parameters,
        moments and step count (the lazy word table's too, under
        ``--opt_impl lazy_emb``), the generator, the step and epoch, and the
        host generator as it was when that epoch began."""
        if self.checkpointer is None:
            return
        state = self.checkpointer.restore_latest()
        if state is None:
            return
        self.model.load_state_dict(state["model"])
        self.train_step.optimizer.load_state_dict(state["optimizer"])
        lazy = getattr(self.train_step, "lazy", None)
        if lazy is not None:
            lazy.load_state_dict(state["lazy_emb"])
        self.gen.set_state(state["gen"])
        rng = state["host_rng"]
        self.host_rng.set_state(("MT19937", rng["keys"].numpy().astype(np.uint32), rng["pos"],
                                 rng["has_gauss"], rng["gauss"]))
        self.global_step = int(state["step"])
        self.start_epoch = int(state["epoch"])
        self.skip_steps = int(state["step_in_epoch"])

    def _install_preempt_handler(self):
        """SIGTERM -> checkpoint and exit at the next step boundary. Active
        only when checkpoints are on, and only in the main thread."""
        if self.checkpointer is None:
            return None

        def handler(signum, frame):
            logger.warning("SIGTERM received: will checkpoint and exit at the next "
                           "step boundary")
            self._preempted = True

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not the main thread
            return None

    def _preempt_save(self, epoch: int, step_in_epoch: int) -> None:
        if self.checkpointer.latest_step() == self.global_step:
            logger.info("preemption save skipped (step %d already saved)", self.global_step)
        else:
            self._save(epoch, step_in_epoch)
        if self.checkpointer.latest_step() != self.global_step:
            raise RuntimeError(f"preemption checkpoint at step {self.global_step} did not "
                               "commit")
        logger.warning("preemption checkpoint saved at step %d (resume with --resume)",
                       self.global_step)

    # -- train ----------------------------------------------------------------

    def _log_train(self, epoch: int, m: Dict[str, float], note: str = "") -> None:
        acc = 100.0 * m["correct"] / max(m["n"], 1.0)
        logger.info("step %d loss %.4f acc %.2f%%%s", self.global_step, m["loss"], acc, note)
        self._write_jsonl({"kind": "train", "step": self.global_step, "epoch": epoch,
                           "accuracy": acc,
                           **{k: v for k, v in m.items() if k not in ("correct", "n")}})

    def _crossed(self, prev: int, every: int) -> bool:
        return prev // every != self.global_step // every

    def _fit_epoch(self, train_pipe, epoch: int, skip: int) -> int:
        """One epoch a step at a time; returns the steps taken."""
        done = skip
        for batch in train_pipe.device_iter(self.device, shuffle=True, rng=self.host_rng,
                                            skip=skip):
            metrics = self.train_step(batch, self.gen)
            prev = self.global_step
            self.global_step += 1
            if self.on_step is not None:
                self.on_step(self.global_step, metrics)
            if done % self.log_every == 0:
                self._log_train(epoch, {k: float(v) for k, v in metrics.items()})
            done += 1
            if self.checkpointer is not None and self._crossed(
                    prev, self.checkpointer.every_steps):
                self._save(epoch, done)
            if self._preempted:
                break
        return done - skip

    def _fit_epoch_chunked(self, train_pipe, epoch: int, skip: int) -> int:
        """One epoch in chunks of ``steps_per_dispatch`` steps (the JAX
        ``_fit_epoch_chunked``); returns the steps taken."""
        done = skip
        for batches, k_real in train_pipe.device_iter_chunks(
                self.device, self.steps_per_dispatch, shuffle=True, rng=self.host_rng,
                skip=skip):
            if self._preempted:
                break
            metrics = self.train_many(batches, k_real, self.gen)
            prev = self.global_step
            self.global_step += k_real
            done += k_real
            if self.on_step is not None:
                self.on_step(self.global_step, metrics)
            if self._crossed(prev, max(self.log_every, 1)):
                m = {k: v.float().cpu().numpy() for k, v in metrics.items()}
                mean = {k: float(np.mean(v)) for k, v in m.items()}
                mean["correct"], mean["n"] = float(m["correct"].sum()), float(m["n"].sum())
                self._log_train(epoch, mean, f" (chunk of {k_real})")
            if self.checkpointer is not None and self._crossed(
                    prev, self.checkpointer.every_steps):
                self._save(epoch, done)
        return done - skip

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
        # restore only when asked: a rerun into a results directory that
        # holds older checkpoints starts from step 0, as in the JAX package
        if self.resume:
            self.maybe_resume()
        res_val: List[Dict] = []
        res_te: List[Dict] = []
        chunked = self.train_many is not None and self.steps_per_dispatch > 1
        prof = None
        if self.profile_dir:
            os.makedirs(self.profile_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.profile_dir))
            prof.start()
        restore_sig = self._install_preempt_handler()
        try:
            for epoch in range(self.start_epoch, epochs):
                logger.info("Epoch: %d", epoch + 1)
                skip, self.skip_steps = self.skip_steps, 0
                # (a resumed run's host generator is at this epoch's start too)
                self._epoch_rng = self.host_rng.get_state()
                t_epoch = time.perf_counter()
                fit_epoch = self._fit_epoch_chunked if chunked else self._fit_epoch
                steps = fit_epoch(train_pipe, epoch, skip)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t_epoch
                seen = steps * int(train_pipe.cfg.batch_size)
                logger.info("epoch %d: %.1fs, %.2f steps/s, %.1f posts/s",
                            epoch + 1, dt, steps / dt, seen / dt)
                self._write_jsonl({"kind": "epoch", "epoch": epoch, "seconds": dt,
                                   "steps_per_sec": steps / dt, "posts_per_sec": seen / dt})
                if self._preempted:
                    self._preempt_save(epoch, skip + steps)
                    break
                self._epoch_eval(val_pipe, te_pipe, epoch, epochs, res_val, res_te,
                                 val_filename, te_filename)
        finally:
            if restore_sig is not None:
                signal.signal(signal.SIGTERM, restore_sig)
            if prof is not None:
                prof.stop()
        if model_path:
            from .checkpoint import save_params

            save_params(model_path, self.model)
        return res_val, res_te

    # -- eval -----------------------------------------------------------------

    def evaluate(self, pipe, collect_features: bool = False, feature_step=None) -> Dict:
        """The eval result: per-batch mean loss, stacked predictions,
        labels and data ids of the valid rows, summed confusion counts (and
        with ``collect_features`` the valid rows' ``feature_step``
        features, a step at a time, as in the JAX package)."""
        self.eval_gen.manual_seed(self.seed + 10_000_000)
        chunked = (self.eval_many is not None and self.steps_per_dispatch > 1
                   and not collect_features)
        losses, preds, targets, data_ids, features = [], [], [], [], []
        cm = None
        correct = n = 0.0

        def take(out, valid, ids):
            nonlocal cm, correct, n
            losses.append(float(out["loss"]))
            preds.append(out["predictions"][valid])
            targets.append(out["targets"][valid])
            data_ids.append(np.asarray(ids)[valid])
            cm = out["cm"] if cm is None else cm + out["cm"]
            correct += float(out["correct"])
            n += float(out["n"])

        if chunked:
            for batches, k_real in pipe.device_iter_chunks(self.device,
                                                           self.steps_per_dispatch):
                out = {k: v.cpu().numpy()
                       for k, v in self.eval_many(batches, k_real, self.eval_gen).items()}
                valid = batches["valid"].cpu().numpy().astype(bool)
                for j in range(k_real):
                    take({k: v[j] for k, v in out.items()}, valid[j], batches["data_id"][j])
        else:
            for batch in pipe.device_iter(self.device, shuffle=False):
                out = {k: v.cpu().numpy() for k, v in self.eval_step(batch, self.eval_gen).items()}
                valid = batch["valid"].cpu().numpy().astype(bool)
                take(out, valid, batch["data_id"])
                if collect_features:
                    feats, _ = feature_step(batch)
                    features.append(feats.float().cpu().numpy()[valid])
        eval_loss = float(np.mean(losses)) if losses else float("nan")
        logger.info("loss: %.4f acc: %.4f", eval_loss, 100.0 * correct / max(n, 1.0))
        res = {
            "data_id": np.concatenate(data_ids) if data_ids else np.array([]),
            "loss": eval_loss,
            "predictions": np.concatenate(preds) if preds else np.array([]),
            "labels": np.concatenate(targets) if targets else np.array([]),
            "cm": cm,
        }
        if collect_features:
            res["features"] = np.concatenate(features) if features else np.array([])
        return res
