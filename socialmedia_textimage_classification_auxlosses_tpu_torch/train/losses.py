"""Losses of the trainers.

Counterpart of the JAX package's ``train/losses.py``, the same six functions
and the same semantics:

* ``weighted_ce``     - cross entropy over float one-hot / probability targets
                        with class weights: ``-sum_c w_c t_c log p_c`` per
                        row, mean over rows;
* ``int_ce``          - unweighted cross entropy with integer labels (ITM);
* ``bce_with_logits`` - ``BCEWithLogitsLoss(pos_weight)`` (multilabel);
* ``contrastive_loss``/``clip_loss`` - the symmetric image-text contrastive
                        loss over the similarity matrix, diagonal targets;
* ``loss_correction`` - the binary noisy-label correction;
* ``combined_loss``   - ``(1 - sum betas) CE + beta_itc ITC + beta_itm ITM``.

Every loss takes an optional per-row ``mask`` (the ``valid`` column of a
padded batch): masked rows leave the mean, and the contrastive loss also
drops masked columns as negatives (a -1e9 bias). All of it runs in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG_BIAS = -1e9


def _masked_mean(per_sample, mask):
    if mask is None:
        return per_sample.mean()
    mask = mask.to(per_sample.dtype)
    return (per_sample * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def weighted_ce(logits, targets, class_weights=None, mask=None, reduction="mean"):
    """torch's probability-target cross entropy with class weights: 'mean'
    divides by the number of rows, not by the weight sum."""
    logp = F.log_softmax(logits.float(), dim=-1)
    targets = targets.float()
    w = targets if class_weights is None else targets * class_weights[None, :]
    per_sample = -(w * logp).sum(dim=-1)
    if reduction == "none":
        return per_sample
    return _masked_mean(per_sample, mask)


def int_ce(logits, labels, mask=None, reduction="mean"):
    logp = F.log_softmax(logits.float(), dim=-1)
    per_sample = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if reduction == "none":
        return per_sample
    return _masked_mean(per_sample, mask)


def bce_with_logits(logits, targets, pos_weight=None, mask=None):
    logits, targets = logits.float(), targets.float()
    log_p = -F.softplus(-logits)
    log_not_p = -F.softplus(logits)
    w = torch.ones_like(targets) if pos_weight is None else pos_weight.expand_as(targets)
    per_elem = -(w * targets * log_p + (1.0 - targets) * log_not_p)
    return _masked_mean(per_elem.mean(dim=-1), mask)


def contrastive_loss(logits, mask=None):
    """CE(logits, arange(N)): one direction of the CLIP objective."""
    n = logits.shape[0]
    logits = logits.float()
    if mask is not None:
        logits = logits + torch.where(mask > 0, 0.0, _NEG_BIAS)[None, :]
    labels = torch.arange(n, device=logits.device)
    return int_ce(logits, labels, mask=mask)


def clip_loss(similarity, mask=None):
    """Symmetric image-text contrastive loss; ``similarity`` is
    logits_per_text (rows texts, columns images)."""
    return (contrastive_loss(similarity, mask) + contrastive_loss(similarity.T, mask)) / 2.0


def loss_correction(T, logits, targets, class_weights=None, mask=None):
    """Binary noisy-label correction, ``T[i][j] = P(observed j | true i)``."""
    eneg, one_minus_eneg = T[0][1], T[0][0]
    eplus, one_minus_eplus = T[1][0], T[1][1]
    n = logits.shape[0]
    zeros = torch.tensor([[1.0, 0.0]], device=logits.device).expand(n, 2)
    ones = torch.tensor([[0.0, 1.0]], device=logits.device).expand(n, 2)
    loss_zero = weighted_ce(logits, zeros, class_weights, reduction="none")
    loss_one = weighted_ce(logits, ones, class_weights, reduction="none")
    is_one = targets.argmax(dim=1) == 1
    corrected = torch.where(is_one, one_minus_eneg * loss_one - eplus * loss_zero,
                            one_minus_eplus * loss_zero - eneg * loss_one)
    return _masked_mean(corrected / (one_minus_eplus - eneg), mask)


def combined_loss(cls_loss, itc_loss: Optional[torch.Tensor], itm_loss: Optional[torch.Tensor],
                  beta_itc: Optional[float], beta_itm: Optional[float]):
    """The paper's beta-weighted objective; a term drops out when its loss
    is None."""
    if itc_loss is not None and itm_loss is not None:
        return (1.0 - (beta_itc + beta_itm)) * cls_loss + beta_itc * itc_loss + beta_itm * itm_loss
    if itc_loss is not None:
        return (1.0 - beta_itc) * cls_loss + beta_itc * itc_loss
    if itm_loss is not None:
        return (1.0 - beta_itm) * cls_loss + beta_itm * itm_loss
    return cls_loss
