"""Offline dataset-key builders: convert the raw dataset releases into the
unified ``data_key_*.csv`` contract (columns ``tweet_id,text,label,split``).

Counterpart of the JAX package's ``data/keys.py`` (reference
``preprocessing/text_processing.py:16-171``), written with ``csv`` and numpy:
the card's machine has no pandas. Each builder returns the table as an
ordered ``{column: [values]}`` dict (the values the JAX builder's DataFrame
holds) and writes, given ``out_path``, the CSV that ``DataFrame.to_csv(path,
index=False)`` writes, byte for byte.

* MHP: tweet text + OCR image text merged, splits from the release's
  train/dev/test files (sizes 3998/502/500).
* MVSA: ``valid_pairlist.txt`` + per-id ``.txt`` files, a random 80/10/10
  split (sizes 3608/451/452). The text is the line's UTF-8 ``bytes``, as the
  reference keeps it, so the CSV holds ``b'...'``.
* TIR: the CSV repair of rows whose tweet text holds unescaped commas, a
  random 80/10/10 or id-file split (sizes 3576/447/448).

The random split draws ``np.random.RandomState(seed).permutation(n)``, as the
JAX ``_random_split`` does, so both give the same split. Where the JAX
builders read a release with ``pandas.read_csv``, the cells are typed as its
default parser types a column (``read_release_csv``): the default NA strings
are missing, a column of integers is ``int``, one of numbers ``float``, any
other ``str``.
"""

from __future__ import annotations

import csv
import os
import re
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..utils.logging import get_logger

logger = get_logger(__name__)

Table = Dict[str, list]

# pandas.read_csv's default na_values
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"\s*[+-]?\d+\s*$")


def _random_split(n: int, rng: np.random.RandomState) -> List[str]:
    """80/10/10 split by index sampling (reference text_processing.py:77-88)."""
    order = rng.permutation(n)
    n_tr, n_dev = int(n * 0.8), int(n * 0.1)
    split = [""] * n
    for rows, name in ((order[:n_tr], "train"), (order[n_tr:n_tr + n_dev], "val"),
                       (order[n_tr + n_dev:], "test")):
        for i in rows:
            split[i] = name
    return split


def _typed_column(cells: List[str]) -> list:
    """One column's strings typed as pandas' default parser types them:
    NA strings -> None, then all integers (and no NA) -> int, all numbers ->
    float (NA -> nan), else str (NA -> None)."""
    present = [c for c in cells if c not in NA_STRINGS]
    if present and len(present) == len(cells) and all(_INT.match(c) for c in cells):
        return [int(c) for c in cells]
    try:
        if any("_" in c for c in present):  # Python's float() takes 1_000, pandas does not
            raise ValueError
        return [float(c) if c not in NA_STRINGS else float("nan") for c in cells]
    except ValueError:
        return [None if c in NA_STRINGS else c for c in cells]


def read_release_csv(path: str) -> Table:
    """A release CSV read as ``pandas.read_csv(path, encoding="utf-8")``
    reads it: a header row, cells typed per column (``_typed_column``)."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _typed_column([r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(header)}


def _as_str(value) -> str:
    """``Series.astype(str)`` of one cell."""
    if value is None:
        return "nan"
    return str(value)


def _csv_cell(value):
    """A cell as ``DataFrame.to_csv`` writes it: missing values empty."""
    if value is None or (isinstance(value, float) and value != value):
        return ""
    return value


def write_table_csv(table: Table, path: str) -> None:
    """``DataFrame(table).to_csv(path, index=False)``: the header, then one
    row per record, through ``csv.writer`` with ``\\n`` line ends as pandas
    writes them."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(table))
        for row in zip(*table.values()):
            w.writerow([_csv_cell(v) for v in row])


def _finish(table: Table, name: str, out_path: Optional[str]) -> Table:
    logger.info("%s split counts: %s", name, dict(Counter(table["split"]).most_common()))
    if out_path:
        write_table_csv(table, out_path)
        logger.info("%s saved!", out_path)
    return table


def prepare_data_key_mhp(data_path: str, out_path: Optional[str] = None) -> Table:
    raw = os.path.join(data_path, "MHP", "Data", "{}", "dog_whistle_{}.csv")
    table: Table = {"tweet_id": [], "text": [], "label": [], "split": []}
    for split in ("train", "validation", "test"):
        fname = "dev" if split == "validation" else split
        df = read_release_csv(raw.format(split.title(), fname))
        for t, ocr in zip(df["tweet_text"], df["img_text"]):
            table["text"].append(t + ocr if isinstance(ocr, str) else t)
        table["tweet_id"] += [_as_str(v) for v in df["image_number"]]
        table["label"] += [int(v) for v in df["Primary_numeric_gt"]]
        table["split"] += ["val" if split == "validation" else split] * len(df["image_number"])
    return _finish(table, "MHP", out_path)


def prepare_data_key_mvsa(data_path: str, out_path: Optional[str] = None,
                          seed: int = 0) -> Table:
    raw = os.path.join(data_path, "MVSA-Single", "data")
    pairlist = os.path.join(data_path, "MVSA-Single", "valid_pairlist.txt")
    table: Table = {"tweet_id": [], "text": [], "label": []}
    with open(pairlist) as f:
        for line in f:
            file_id, label = line.strip().split(",")[:2]
            with open(os.path.join(raw, file_id + ".txt"), encoding="ISO-8859-1") as tf:
                text = tf.readline().encode("utf-8").strip()
            table["tweet_id"].append(file_id)
            table["text"].append(text)
            table["label"].append(int(label))
    table["split"] = _random_split(len(table["tweet_id"]), np.random.RandomState(seed))
    return _finish(table, "MVSA", out_path)


def _read_tir_csv(raw_csv: str) -> Table:
    """The TIR release has rows where the tweet text contains unescaped
    commas; re-join the overflow columns (reference text_processing.py:96-116).
    Every cell stays a string (a row short of the header is missing the rest);
    ``tweet`` becomes ``text`` and a row counter goes first, named ``index``,
    or ``level_0`` where the release has an ``index`` column
    (``DataFrame.reset_index``)."""
    rows = []
    with open(raw_csv) as f:
        reader = csv.reader(f, delimiter=",")
        headers = next(reader)
        for row in reader:
            if len(row) > len(headers):
                extra = len(row) - len(headers)
                row = row[:2] + [", ".join(row[2:2 + extra + 1])] + row[2 + extra + 1:]
            rows.append(row)
    counter = "level_0" if "index" in headers else "index"
    table: Table = {counter: list(range(len(rows)))}
    for j, name in enumerate(headers):
        table["text" if name == "tweet" else name] = [r[j] if j < len(r) else None
                                                      for r in rows]
    return table


def prepare_data_key_tir(raw_csv: str, out_path: Optional[str] = None,
                         split_mode: str = "random",
                         split_files_prefix: Optional[str] = None,
                         seed: int = 0) -> Table:
    data = _read_tir_csv(raw_csv)
    n = len(data["tweet_id"])
    if split_mode == "random":
        data["split"] = _random_split(n, np.random.RandomState(seed))
    else:
        # id-file split (reference text_processing.py:139-171)
        with open(f"{split_files_prefix}_train.txt") as f:
            train_ids = {x.strip() for x in f}
        with open(f"{split_files_prefix}_test.txt") as f:
            test_ids = {x.strip() for x in f}
        split, not_found = [], []
        for tweet_id in data["tweet_id"]:
            tid = "T" + str(tweet_id).strip()
            if tid in train_ids:
                split.append("train")
            elif tid in test_ids:
                split.append("test")
            else:
                not_found.append(tid)
        if not_found:
            raise ValueError(f"{len(not_found)} ids not in split files")
        data["split"] = split
    return _finish(data, "TIR", out_path)
