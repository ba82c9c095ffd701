"""Data preparation: splits, labels and class weights, without pandas.

Counterpart of the JAX package's ``data/prep.py``. The data is the table of
``core.config.Config`` (``{column: numpy array}``); the observable behaviour
is the JAX package's: split by the ``split`` column, an optional 200-row
``--testing`` subsample before splitting, an optional ``--nsamples`` train
cap, one-hot float labels, sklearn-style balanced class weights (multilabel:
positive weights). ``prepare_text_data`` reads the text-only MIC eval set
(``--eval_txt_test``). The JAX package's per-task id munging and the
random-label and no-weights options have no caller here.

The subsamples pick the rows pandas' ``DataFrame.sample(n, random_state=rng)``
picks, in its order: ``rng.choice(len, n, replace=False)`` positions
(``tests/test_torch_data.py`` holds this against pandas).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Optional

import numpy as np


def vectorize_labels(y: np.ndarray, num_labels: int) -> np.ndarray:
    """Integer class ids -> one-hot float matrix."""
    out = np.zeros((len(y), num_labels), dtype=np.float32)
    out[np.arange(len(y)), np.asarray(y, dtype=np.int64)] = 1.0
    return out


def balanced_class_weights(y: np.ndarray, num_labels: int) -> np.ndarray:
    """sklearn ``compute_class_weight("balanced")``: n / (classes * bincount);
    a class absent from train gets weight 1."""
    y = np.asarray(y, dtype=np.int64)
    counts = np.bincount(y, minlength=num_labels).astype(np.float64)
    with np.errstate(divide="ignore"):
        w = len(y) / (num_labels * counts)
    w[~np.isfinite(w)] = 1.0
    return w.astype(np.float32)


def multilabel_pos_weights(y: np.ndarray) -> np.ndarray:
    """(N - count) / count per label column."""
    y = np.asarray(y, dtype=np.float64)
    count = y.sum(axis=0)
    with np.errstate(divide="ignore"):
        w = (len(y) - count) / count
    w[~np.isfinite(w)] = 1.0
    return w.astype(np.float32)


@dataclasses.dataclass
class SplitArrays:
    """One split's host-side arrays."""

    ids: np.ndarray        # tweet ids (ints or strings)
    ids_num: np.ndarray    # int64 ids for the CSV contract (data_id column)
    text: np.ndarray       # object array of raw texts
    labels: np.ndarray     # (N, num_labels) float32 one-hot / multilabel
    image_adds: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.text)


def _ids_to_num(ids: np.ndarray) -> np.ndarray:
    """Numeric data_id of the prediction CSVs: the id itself, or for a
    non-numeric id a hash, as the JAX package does for the registry's tasks."""
    def one(x):
        try:
            return float(x)
        except (ValueError, TypeError):
            return float(abs(hash(str(x))) % 10**12)

    return np.asarray([one(x) for x in ids], dtype=np.int64)


def sample_rows(n: int, k: int, rng: np.random.RandomState) -> np.ndarray:
    """The positions ``DataFrame.sample(k, random_state=rng)`` takes from a
    frame of ``n`` rows, in its order."""
    return rng.choice(n, size=k, replace=False)


def prepare_data(
    data: Dict[str, np.ndarray],
    num_labels: int,
    testing: bool = False,
    nsamples: int = -1,
    load_image_adds: bool = False,
    multilabel: bool = False,
    rng: Optional[np.random.RandomState] = None,
):
    """The data table -> (train, val, test) SplitArrays + class weights."""
    rng = rng or np.random.RandomState(0)
    rows = np.arange(len(data["split"]))
    if testing:
        rows = rows[sample_rows(len(rows), min(200, len(rows)), rng)]
    split = data["split"]
    train = rows[split[rows] == "train"]
    if nsamples > 0:
        train = train[sample_rows(len(train), min(nsamples, len(train)), rng)]
    val = rows[split[rows] == "val"]
    test = rows[split[rows] == "test"]

    def labels_of(idx):
        y = data["label"][idx]
        if multilabel:
            return np.asarray([ast.literal_eval(x) if isinstance(x, str) else x
                               for x in y], dtype=np.float32)
        return vectorize_labels(y, num_labels)

    splits = {}
    for name, idx in (("train", train), ("val", val), ("test", test)):
        splits[name] = SplitArrays(
            ids=data["tweet_id"][idx],
            ids_num=_ids_to_num(data["tweet_id"][idx]),
            text=data["text"][idx],
            labels=labels_of(idx),
            image_adds=data["image_adds"][idx] if load_image_adds else None,
        )

    if multilabel:
        class_weights = multilabel_pos_weights(splits["train"].labels)
    else:
        class_weights = balanced_class_weights(data["label"][train].astype(np.int64),
                                               num_labels)
    return splits["train"], splits["val"], splits["test"], class_weights


def prepare_text_data(path: str, num_labels: int = 2, testing: bool = False,
                      rng: Optional[np.random.RandomState] = None) -> SplitArrays:
    """The text-only MIC eval set: the CSV at ``path`` (columns id, text,
    label), all rows, or under ``testing`` a 100-row sample, as the JAX
    package's ``prepare_text_data`` takes it."""
    from ..core.config import read_csv

    rng = rng or np.random.RandomState(0)
    data = read_csv(path)
    rows = np.arange(len(data["id"]))
    if testing:
        rows = rows[sample_rows(len(rows), min(100, len(rows)), rng)]
    return SplitArrays(ids=data["id"][rows], ids_num=_ids_to_num(data["id"][rows]),
                       text=data["text"][rows],
                       labels=vectorize_labels(data["label"][rows], num_labels))
