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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

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


def predictions(cfg: LossConfig, out_cls, labels):
    if cfg.multilabel:
        return torch.round(torch.sigmoid(out_cls)).int(), labels.int()
    return out_cls.argmax(dim=-1).int(), labels.argmax(dim=-1).int()


def accuracy_counts(cfg: LossConfig, preds, targets, valid):
    v = torch.ones(preds.shape[0], device=preds.device) if valid is None else valid.float()
    if cfg.multilabel:
        return ((preds == targets).float() * v[:, None]).sum(), v.sum() * preds.shape[-1]
    return ((preds == targets).float() * v).sum(), v.sum()


def maybe_tim(cfg: LossConfig, gen, batch):
    """(tim_inputs, tim_labels): the swapped texts and their row sources,
    drawn from ``gen`` or injected by the batch."""
    if not cfg.use_tim_loss:
        return None, None
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
                 keep_grads: bool = False):
        self.model = model
        self.forward_fn = forward_fn
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.class_weights = class_weights
        self.keep_grads = keep_grads
        self.last_grads: Optional[Dict] = None

    def gradients(self, batch, gen):
        """(grads by name, loss parts, outputs) of one batch, no update."""
        self.model.train()
        tim_inputs, tim_labels = maybe_tim(self.loss_cfg, gen, batch)
        outputs = self.forward_fn(batch, tim_inputs, gen, False)
        total, parts = assemble_loss(self.loss_cfg, outputs, batch, tim_labels,
                                     self.class_weights)
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
        correct, n = accuracy_counts(self.loss_cfg, preds, targets, batch.get("valid"))
        return {**{k: v.detach() for k, v in parts.items()}, "correct": correct, "n": n}


class EvalStep:
    """``step(batch, gen) -> outputs``: eval-mode forward without a graph,
    loss, predictions and the batch's confusion counts on the device."""

    def __init__(self, model: torch.nn.Module, forward_fn: Callable,
                 loss_cfg: LossConfig, class_weights=None):
        self.model = model
        self.forward_fn = forward_fn
        self.loss_cfg = loss_cfg
        self.class_weights = class_weights

    @torch.no_grad()
    def __call__(self, batch, gen):
        self.model.eval()
        cfg = self.loss_cfg
        tim_inputs, tim_labels = maybe_tim(cfg, gen, batch)
        outputs = self.forward_fn(batch, tim_inputs, None, True)
        _, parts = assemble_loss(cfg, outputs, batch, tim_labels, self.class_weights)
        preds, targets = predictions(cfg, outputs["out_cls"], batch["labels"])
        valid = batch.get("valid")
        correct, n = accuracy_counts(cfg, preds, targets, valid)
        cm = (multilabel_counts_update(preds, targets, valid) if cfg.multilabel
              else confusion_matrix_update(preds, targets, cfg.num_labels, valid))
        return {**parts, "predictions": preds, "targets": targets, "cm": cm,
                "correct": correct, "n": n}
