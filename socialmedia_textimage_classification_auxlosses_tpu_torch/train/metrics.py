"""Metrics: confusion counts on the device, P/R/F1 on the host.

Counterpart of the JAX package's ``train/metrics.py``: the eval step adds
each batch into a (C, C) confusion matrix (multiclass) or a per-label
[TP, FP, FN, TN] table (multilabel) in torch, on the batch's device; F1,
precision and recall in their weighted and macro averages are numpy on the
host, copied from the JAX package with its conventions (zero division -> 0,
macro over all C classes, weighted by true-label support) and its CSV
contracts (``compute_metrics``, ``agg_metrics_val``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def confusion_matrix_update(preds, targets, num_classes: int, mask=None):
    """One batch's (C, C) confusion counts, rows = true, cols = pred;
    ``mask`` zeroes padded rows."""
    one = (torch.ones(preds.shape[0], device=preds.device) if mask is None
           else mask.float())
    flat = (targets.long() * num_classes + preds.long())
    cm = torch.zeros(num_classes * num_classes, device=preds.device).index_add_(0, flat, one)
    return cm.reshape(num_classes, num_classes)


def multilabel_counts_update(preds, targets, mask=None):
    """Per-label [TP, FP, FN, TN] counts (L, 4) for one batch."""
    p, t = preds.float(), targets.float()
    m = (torch.ones(p.shape[0], 1, device=p.device) if mask is None
         else mask.float()[:, None])
    tp = (m * p * t).sum(0)
    fp = (m * p * (1 - t)).sum(0)
    fn = (m * (1 - p) * t).sum(0)
    tn = (m * (1 - p) * (1 - t)).sum(0)
    return torch.stack([tp, fp, fn, tn], dim=-1)


def _safe_div(a, b):
    return np.divide(a, b, out=np.zeros_like(a, dtype=np.float64), where=b != 0)


def metrics_from_confusion(cm: np.ndarray) -> Dict[str, float]:
    """Multiclass P/R/F1 in weighted and macro averages from a (C,C) matrix."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    support = cm.sum(axis=1)          # true-label counts
    pred_count = cm.sum(axis=0)       # predicted-label counts
    precision = _safe_div(tp, pred_count)
    recall = _safe_div(tp, support)
    f1 = _safe_div(2 * precision * recall, precision + recall)
    total = support.sum()
    wts = _safe_div(support, np.array(total)) if total > 0 else np.zeros_like(support)
    return {
        "f1_weighted": float(np.sum(f1 * wts)),
        "f1_macro": float(np.mean(f1)),
        "precision_weighted": float(np.sum(precision * wts)),
        "precision_macro": float(np.mean(precision)),
        "recall_weighted": float(np.sum(recall * wts)),
        "recall_macro": float(np.mean(recall)),
    }


def metrics_from_multilabel_counts(counts: np.ndarray) -> Dict[str, float]:
    """Multilabel P/R/F1 from per-label [TP, FP, FN, TN] counts (L, 4)."""
    counts = np.asarray(counts, dtype=np.float64)
    tp, fp, fn = counts[:, 0], counts[:, 1], counts[:, 2]
    precision = _safe_div(tp, tp + fp)
    recall = _safe_div(tp, tp + fn)
    f1 = _safe_div(2 * precision * recall, precision + recall)
    support = tp + fn
    total = support.sum()
    wts = _safe_div(support, np.array(total)) if total > 0 else np.zeros_like(support)
    return {
        "f1_weighted": float(np.sum(f1 * wts)),
        "f1_macro": float(np.mean(f1)),
        "precision_weighted": float(np.sum(precision * wts)),
        "precision_macro": float(np.mean(precision)),
        "recall_weighted": float(np.sum(recall * wts)),
        "recall_macro": float(np.mean(recall)),
    }


def compute_metrics(res: Dict, num_classes: int, multilabel: bool = False) -> Dict[str, List]:
    """Reference-contract metric table (reference utils.py:294-325).

    ``res`` carries ``predictions``/``labels`` (1-D class ids, or (N, L)
    multilabel 0/1 arrays) and ``loss``.
    """
    y_pred = np.asarray(res["predictions"])
    y = np.asarray(res["labels"])
    if multilabel:
        counts = np.zeros((num_classes, 4))
        tp = (y_pred * y).sum(axis=0)
        fp = (y_pred * (1 - y)).sum(axis=0)
        fn = ((1 - y_pred) * y).sum(axis=0)
        tn = ((1 - y_pred) * (1 - y)).sum(axis=0)
        counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3] = tp, fp, fn, tn
        results = metrics_from_multilabel_counts(counts)
    else:
        cm = np.zeros((num_classes, num_classes))
        np.add.at(cm, (y.astype(int), y_pred.astype(int)), 1)
        results = metrics_from_confusion(cm)
    results["loss"] = float(res["loss"])
    return {"metric": list(results.keys()), "result": list(results.values())}


def agg_metrics_val(res_list: List[Dict], metric_names: List[str], num_labels: int,
                    multilabel: bool = False) -> Dict[str, List]:
    """Metric x epoch table (reference utils.py:327-335): one ``epoch-{n}``
    column per eval, rows ordered by ``metric_names``."""
    table: Dict[str, List] = {"metric": metric_names}
    for res in res_list:
        metrics = compute_metrics(res, num_labels, multilabel=multilabel)
        lookup = dict(zip(metrics["metric"], metrics["result"]))
        table["epoch-" + str(res["epoch"] + 1)] = [lookup[m] for m in metric_names]
    return table
