"""Train and eval steps.

Counterpart of the JAX package's ``train/steps.py``: one generic step over a
``forward_fn`` that returns the model's output dict, and the loss assembly
of the paper's objective:

    multilabel -> BCE(pos_weight)       else weighted CE over one-hot floats
    + beta_itc * ITC + beta_itm * ITM   (down-weighting the CE term)
    | beta_iadds * iadds CE             (legacy, exclusive with the above)
    | loss correction                   (legacy binary path)

Batches have a fixed shape and a ``valid`` row mask. The ITM swap happens in
the step, drawn from the step's ``torch.Generator`` before the dropout
masks, or comes in the batch (``tim_src``/``tim_labels``), which pins it for
comparisons. The train step runs the forward in training mode (the TIM texts
re-encoded with their own dropout masks, 2B rows through the text tower),
takes the gradient of the total loss with respect to the optimizer's
trainable parameters and applies ``AdamW``. The eval step runs in eval mode
without a graph; its TIM swap stays stochastic, as the reference's eval is,
and it reuses the primary pass's text rows for the TIM rows (exact there).

A seed-stacked model (``models/encoder.py::stack_seed_models``, the sweep of
``train/ensemble.py``) takes ``seeds`` = S: the batch holds S·B seed-major
rows, ``gen`` is a tuple of S generators, and each seed's TIM swap is drawn
from its own generator on its own rows, before the dropout masks, as its
own run draws it. Each seed's loss is ``assemble_loss`` on its rows with its
class weights; their sum is differentiated once (each parameter slice
belongs to one seed, so each seed's gradients are those of its loss alone)
and AdamW steps the stacked tensors. Metrics, predictions and confusion
counts come per seed: every metric an (S,) tensor.

``make_train_many`` / ``make_eval_many`` (``--steps_per_dispatch K``) run
the steps of a chunk of K stacked batches. On a CUDA device each step is
one replay of a CUDA graph of the whole step (``StepGraph``): the host
enqueues a graph launch instead of the step's thousands of kernels. On the
CPU the same loop runs the eager steps. ``make_feature_step`` gives the
fusion head's ``mm_features`` (``--extract_features``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import _cuda
from . import losses as L
from .itm import itm_swap
from .metrics import confusion_matrix_update, multilabel_counts_update


@dataclasses.dataclass(frozen=True)
class LossConfig:
    num_labels: int
    multilabel: bool = False
    use_clip_loss: bool = False
    use_tim_loss: bool = False
    use_iadds_loss: bool = False
    use_loss_correction: bool = False
    beta_itc: Optional[float] = None
    beta_itm: Optional[float] = None
    beta_iadds: Optional[float] = None
    T: Tuple[Tuple[float, float], ...] = ((0.9, 0.1), (0.1, 0.9))


def _cls_loss(cfg: LossConfig, out_cls, labels, class_weights, valid):
    if cfg.multilabel:
        return L.bce_with_logits(out_cls, labels, pos_weight=class_weights, mask=valid)
    if cfg.use_loss_correction:
        return L.loss_correction(cfg.T, out_cls, labels, class_weights, mask=valid)
    return L.weighted_ce(out_cls, labels, class_weights, mask=valid)


def assemble_loss(cfg: LossConfig, outputs: Dict, batch: Dict, tim_labels,
                  class_weights):
    valid = batch.get("valid")
    cls_loss = _cls_loss(cfg, outputs["out_cls"], batch["labels"], class_weights, valid)
    parts = {"cls_loss": cls_loss}
    itc = itm = None
    if cfg.use_clip_loss:
        itc = L.clip_loss(outputs["logits_per_text"], mask=valid)
        parts["itc_loss"] = itc
    if cfg.use_tim_loss:
        itm = L.int_ce(outputs["out_tim"], tim_labels, mask=valid)
        parts["itm_loss"] = itm
    if cfg.use_iadds_loss and not (cfg.use_clip_loss or cfg.use_tim_loss):
        iadds = L.int_ce(outputs["out_iadds"], batch["image_adds"], mask=valid)
        parts["iadds_loss"] = iadds
        total = (1.0 - cfg.beta_iadds) * cls_loss + cfg.beta_iadds * iadds
    else:
        total = L.combined_loss(cls_loss, itc, itm, cfg.beta_itc, cfg.beta_itm)
    parts["loss"] = total
    return total, parts


def step_loss(cfg: LossConfig, outputs: Dict, batch: Dict, tim_labels, class_weights,
              seeds: int = 0):
    """``assemble_loss``; for a seed-stacked step (``seeds`` = S) the sum of
    the seeds' totals and each loss part as an (S,) tensor, ``class_weights``
    one per seed (or None)."""
    if not seeds:
        return assemble_loss(cfg, outputs, batch, tim_labels, class_weights)
    outs = seed_split({k: v for k, v in outputs.items() if v is not None}, seeds)
    labels = [None] * seeds if tim_labels is None else tim_labels.reshape(seeds, -1)
    weights = class_weights or [None] * seeds
    totals, parts = zip(*(assemble_loss(cfg, o, b, t, w) for o, b, t, w in zip(
        outs, seed_split(batch, seeds), labels, weights)))
    return sum(totals), {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def predictions(cfg: LossConfig, out_cls, labels):
    if cfg.multilabel:
        return torch.round(torch.sigmoid(out_cls)).int(), labels.int()
    return out_cls.argmax(dim=-1).int(), labels.argmax(dim=-1).int()


def accuracy_counts(cfg: LossConfig, preds, targets, valid, seeds: int = 0):
    """(correct, counted) over the valid rows; per seed, as (S,) tensors,
    with ``seeds``."""
    v = torch.ones(preds.shape[0], device=preds.device) if valid is None else valid.float()
    hits = (preds == targets).float() * (v[:, None] if cfg.multilabel else v)
    n = v * preds.shape[-1] if cfg.multilabel else v
    if seeds:
        return hits.reshape(seeds, -1).sum(1), n.reshape(seeds, -1).sum(1)
    return hits.sum(), n.sum()


def seed_split(tree: Dict, s: int) -> list:
    """The S per-seed dicts of a dict of seed-major rows (tensors and host
    arrays split along their first axis; other values, and None, kept).
    Tensors split by ``unbind``: its backward stacks the S gradients once,
    where S selects would each give a zero-filled gradient of the whole."""
    def parts(v):
        if torch.is_tensor(v):
            return v.reshape(s, -1, *v.shape[1:]).unbind(0)
        if isinstance(v, np.ndarray):
            return list(v.reshape(s, -1, *v.shape[1:]))
        return [v] * s

    split = {k: parts(v) for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(s)]


def seed_merge(trees: list) -> Dict:
    """The inverse of ``seed_split`` for tensors (None kept)."""
    return {k: None if trees[0][k] is None else torch.cat([t[k] for t in trees])
            for k in trees[0]}


def maybe_tim(cfg: LossConfig, gen, batch, seeds: int = 0):
    """(tim_inputs, tim_labels): the swapped texts and their row sources,
    drawn from ``gen`` or injected by the batch. With ``seeds`` = S, each
    seed's swap on its rows from its generator ``gen[i]``; ``src`` then
    indexes all S·B rows."""
    if not cfg.use_tim_loss:
        return None, None
    if seeds:
        parts = [maybe_tim(cfg, g, b) for g, b in zip(gen, seed_split(batch, seeds))]
        rows = batch["ids"].shape[0] // seeds
        inputs = [dict(t, src=t["src"] + i * rows) for i, (t, _) in enumerate(parts)]
        return seed_merge(inputs), torch.cat([labels for _, labels in parts])
    if "tim_src" in batch:
        src = batch["tim_src"].long()
        tim_labels = batch["tim_labels"].int()
        tt = batch.get("token_type_ids")
        tim_ids, tim_mask = batch["ids"][src], batch["mask"][src]
        tim_tt = None if tt is None else tt[src]
    else:
        tim_ids, tim_mask, tim_tt, tim_labels, src = itm_swap(
            gen, batch["ids"], batch["mask"], batch.get("token_type_ids"),
            batch.get("valid"))
    return {"ids": tim_ids, "mask": tim_mask, "token_type_ids": tim_tt,
            "src": src}, tim_labels


class TrainStep:
    """``step(batch, gen) -> metrics``: forward in training mode, loss,
    gradient, AdamW. ``forward_fn(batch, tim_inputs, gen, deterministic)``
    returns the model's output dict. With ``keep_grads`` the last step's
    gradients stay in ``last_grads`` (name -> tensor or None)."""

    def __init__(self, model: torch.nn.Module, forward_fn: Callable,
                 loss_cfg: LossConfig, optimizer, class_weights=None,
                 keep_grads: bool = False, seeds: int = 0):
        self.model = model
        self.forward_fn = forward_fn
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.class_weights = class_weights  # with seeds: one per seed
        self.keep_grads = keep_grads
        self.seeds = seeds
        self.last_grads: Optional[Dict] = None

    def gradients(self, batch, gen):
        """(grads by name, loss parts, outputs) of one batch, no update."""
        self.model.train()
        tim_inputs, tim_labels = maybe_tim(self.loss_cfg, gen, batch, self.seeds)
        outputs = self.forward_fn(batch, tim_inputs, gen, False)
        total, parts = step_loss(self.loss_cfg, outputs, batch, tim_labels,
                                 self.class_weights, self.seeds)
        names = self.optimizer.names
        params = [p for _, p in self.optimizer.params]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return dict(zip(names, grads)), parts, outputs

    def __call__(self, batch, gen):
        grads, parts, outputs = self.gradients(batch, gen)
        self.optimizer.step(grads)
        if self.keep_grads:
            self.last_grads = grads
        preds, targets = predictions(self.loss_cfg, outputs["out_cls"].detach(),
                                     batch["labels"])
        correct, n = accuracy_counts(self.loss_cfg, preds, targets, batch.get("valid"),
                                     self.seeds)
        return {**{k: v.detach() for k, v in parts.items()}, "correct": correct, "n": n}


class EvalStep:
    """``step(batch, gen) -> outputs``: eval-mode forward without a graph,
    loss, predictions and the batch's confusion counts on the device."""

    def __init__(self, model: torch.nn.Module, forward_fn: Callable,
                 loss_cfg: LossConfig, class_weights=None, seeds: int = 0):
        self.model = model
        self.forward_fn = forward_fn
        self.loss_cfg = loss_cfg
        self.class_weights = class_weights
        self.seeds = seeds

    @torch.no_grad()
    def __call__(self, batch, gen):
        self.model.eval()
        cfg, seeds = self.loss_cfg, self.seeds
        tim_inputs, tim_labels = maybe_tim(cfg, gen, batch, seeds)
        outputs = self.forward_fn(batch, tim_inputs, None, True)
        _, parts = step_loss(cfg, outputs, batch, tim_labels, self.class_weights, seeds)
        preds, targets = predictions(cfg, outputs["out_cls"], batch["labels"])
        valid = batch.get("valid")
        correct, n = accuracy_counts(cfg, preds, targets, valid, seeds)

        def counts(p, t, v):
            return (multilabel_counts_update(p, t, v) if cfg.multilabel
                    else confusion_matrix_update(p, t, cfg.num_labels, v))

        if seeds:  # (S, ...) per-seed counts
            rows = [part.reshape(seeds, -1, *part.shape[1:]) for part in (preds, targets)]
            vs = [None] * seeds if valid is None else valid.reshape(seeds, -1)
            cm = torch.stack([counts(rows[0][i], rows[1][i], vs[i]) for i in range(seeds)])
        else:
            cm = counts(preds, targets, valid)
        return {**parts, "predictions": preds, "targets": targets, "cm": cm,
                "correct": correct, "n": n}


class StepGraph:
    """``fn(batch) -> {name: tensor}`` as a CUDA graph, captured once per
    batch signature (the names, shapes and dtypes of the batch's tensors)
    and replayed on every call.

    Capture: the batch's tensors are cloned into static inputs,
    ``warmup(static)`` runs once on a side stream (it must leave the
    parameters, the optimizer and ``generators`` as they were: it loads the
    libraries and initialises what the step's kernels need), then
    ``fn(static)`` is captured with ``generators`` registered, so every
    replay draws new values from them and advances them as an eager step
    would. A call copies the batch into the static inputs, replays, counts
    the kernel launches the capture recorded (``ops/_cuda.py``: a launch is
    counted when it runs) and returns the static outputs, which the next
    replay overwrites. A failed capture raises: no step falls back to eager
    execution.
    """

    def __init__(self, fn: Callable, warmup: Callable, generators=()):
        self.fn, self.warmup, self.generators = fn, warmup, tuple(generators)
        self.graphs: Dict[tuple, tuple] = {}

    def __call__(self, batch: Dict) -> Dict:
        tensors = {k: v for k, v in batch.items() if torch.is_tensor(v)}
        sig = tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in tensors.items()))
        entry = self.graphs.get(sig)
        if entry is None:
            entry = self.graphs[sig] = self._capture(tensors)
        graph, static, out, counts = entry
        for k, v in static.items():
            v.copy_(tensors[k])
        graph.replay()
        _cuda.add_counts(counts)
        return out

    def _capture(self, tensors: Dict):
        static = {k: v.clone() for k, v in tensors.items()}
        device = next(iter(static.values())).device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.warmup(static)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with _cuda.deferred_counts() as counts:
            with torch.cuda.graph(graph):
                out = self.fn(static)
        return graph, static, out, counts


def _run_chunk(step: Callable, batches: Dict, k_real: int) -> Dict:
    """``step`` over the first ``k_real`` batches of a stacked chunk; each
    output is copied into slot i of a (k_real, ...) device buffer, which the
    host reads once per chunk."""
    outs = None
    for i in range(k_real):
        out = step({k: v[i] for k, v in batches.items()})
        if outs is None:
            outs = {k: v.new_empty((k_real,) + tuple(v.shape)) for k, v in out.items()}
        for k, v in out.items():
            outs[k][i].copy_(v)
    return outs


def _chunk_device(batches: Dict) -> torch.device:
    return next(v.device for v in batches.values() if torch.is_tensor(v))


def _make_many(run: Callable, warmup: Callable) -> Callable:
    graphs: Dict[object, StepGraph] = {}

    def many(batches, k_real, gen):
        device = _chunk_device(batches)
        if device.type != "cuda":
            return _run_chunk(lambda b: run(b, gen), batches, k_real)
        graph = graphs.get(gen)
        if graph is None:
            # a tuple of generators: a seed-stacked step, one per seed
            gens = gen if isinstance(gen, tuple) else (gen,)

            def scratch():
                fresh = tuple(torch.Generator(device).manual_seed(0) for _ in gens)
                return fresh if isinstance(gen, tuple) else fresh[0]

            graph = graphs[gen] = StepGraph(lambda b: run(b, gen),
                                            lambda b: warmup(b, scratch()), gens)
        return _run_chunk(graph, batches, k_real)

    return many


def _buffers_kept(model: torch.nn.Module, fn: Callable) -> Callable:
    """``fn`` with the model's buffers (BatchNorm running statistics) put
    back as they were after it: a graph's warm-up step must not move them."""
    def run(*args):
        saved = [b.clone() for b in model.buffers()]
        out = fn(*args)
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)
        return out

    return run


def make_train_many(train_step: TrainStep) -> Callable:
    """The JAX ``make_train_many``: ``many(batches, k_real, gen)`` runs
    ``train_step`` over the first ``k_real`` batches of a chunk
    (``SplitPipeline.device_iter_chunks``) and returns each metric as a
    (k_real,) device tensor. The trajectory is that of ``k_real`` calls of
    ``train_step(batch, gen)``: on a CUDA device each step replays one CUDA
    graph of the step (forward, ``autograd.grad``, AdamW, and the
    BatchNorm buffers' updates of a train-mode forward; warmed up by the
    step's gradients drawn from a scratch generator, the buffers put back
    after it); on the CPU the steps run eagerly."""
    return _make_many(train_step, _buffers_kept(train_step.model, train_step.gradients))


def make_eval_many(eval_step: EvalStep) -> Callable:
    """The JAX ``make_eval_many``: ``many(batches, k_real, gen)`` runs
    ``eval_step`` over the first ``k_real`` batches of a chunk, drawing the
    TIM swaps from ``gen`` as the per-batch path does, and returns each
    output stacked as a (k_real, ...) device tensor. On a CUDA device each
    step replays one CUDA graph of the eval step."""
    return _make_many(eval_step, eval_step)


def make_feature_step(model: torch.nn.Module, forward_fn: Callable) -> Callable:
    """The JAX ``make_feature_step``: ``step(batch) -> (mm_features, label
    ids)`` of an eval-mode forward without a graph."""

    @torch.no_grad()
    def step(batch):
        model.eval()
        outputs = forward_fn(batch, None, None, True)
        return outputs["mm_features"], batch["labels"].argmax(dim=-1)

    return step
