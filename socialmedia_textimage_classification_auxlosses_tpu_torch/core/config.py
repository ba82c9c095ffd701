"""Task registry, the training configuration and the serving configuration.

Counterpart of the JAX package's ``core/config.py``: the constant tables,
``Config(args)`` for the trainers (the task's data key read with ``csv``,
not pandas, into a table of numpy columns), ``task_spec`` and a
``serving_config`` that needs no data files. Paths are anchored at
``SMTC_DATA_PATH`` / ``SMTC_RESULTS_PATH`` (default ``<repo>/data/`` and
``<repo>/results/``), as in the JAX package, so both resolve the same
artifact names.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np

TASKS = {
    0: "text_is_represented",
    1: "image_adds",
    2: "tir",
    3: "mvsa",
    4: "mhp",
    5: "mic",
    6: "msd",
}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


DATA_PATH = os.environ.get("SMTC_DATA_PATH", os.path.join(_repo_root(), "data") + os.sep)
RES_PATH = os.environ.get("SMTC_RESULTS_PATH", os.path.join(_repo_root(), "results") + os.sep)

PATH = {
    0: DATA_PATH + "data_key_imgtxt_random.csv",
    1: DATA_PATH + "data_key_imgtxt_random.csv",
    2: DATA_PATH + "data_key_imgtxt_random.csv",
    3: DATA_PATH + "data_key_mvsa.csv",
    4: DATA_PATH + "data_key_mhp.csv",
    5: DATA_PATH + "data_key_mic.csv",
    6: DATA_PATH + "data_key_msd.csv",
}

IMG_FMT = {
    0: DATA_PATH + "text-image/T{}.jpg",
    1: DATA_PATH + "text-image/T{}.jpg",
    2: DATA_PATH + "text-image/T{}.jpg",
    3: DATA_PATH + "MVSA-Single/data/{}.jpg",
    4: DATA_PATH + "MHP/Data/Images/{}.jpg",
    5: DATA_PATH + "MIC/spc_imgs_twitter/{}_1.jpg",
    6: DATA_PATH + "MSD/dataset_image/{}.jpg",
}

# the text-only MIC eval set and the empty image it is paired with
# (--eval_txt_test)
EMPTY_IMG = DATA_PATH + "MIC/empty_image.png"
TDATA5 = DATA_PATH + "text_data_mic.csv"

CLASSES = {
    2: [
        "image adds and text is represented",
        "image adds and text is not represented",
        "image does not add and text is represented",
        "image does not adds and text is not represented",
    ],
    3: ["neutral", "positive", "negative"],
    6: ["not sarcastic", "sarcastic"],
}

metric_names = [
    "f1_weighted",
    "f1_macro",
    "precision_weighted",
    "precision_macro",
    "recall_weighted",
    "recall_macro",
    "loss",
]

# Noisy-label transition matrix of the (binary) loss-correction objective,
# as the JAX package defines it.
T = [[0.9, 0.1], [0.1, 0.9]]

results_dir_txt = RES_PATH + "txt_only/"
results_dir_img = RES_PATH + "img_only/"
results_dir_mm_early = RES_PATH + "mm_early/"
results_dir_mm_late = RES_PATH + "mm_late/"
results_dir_mmbt = RES_PATH + "mmbt/"

# Model name -> local pretrained directory. When a directory holds a
# config.json its dimensions win over the presets (models/text.py,
# models/vision.py); otherwise the presets and the hashing tokenizer apply.
MODEL_DIR_DICT = {
    "bert": os.environ.get("SMTC_BERT_DIR", DATA_PATH + "hub/BERT-base/"),
    "bertweet": os.environ.get("SMTC_BERTWEET_DIR", DATA_PATH + "hub/BERTWEET-base/"),
    "roberta": os.environ.get("SMTC_ROBERTA_DIR", DATA_PATH + "hub/RoBERTa-base/"),
    "bernice": os.environ.get("SMTC_BERNICE_DIR", DATA_PATH + "hub/BERNICE/"),
    "vit": os.environ.get("SMTC_VIT_DIR", DATA_PATH + "hub/ViT/"),
    "beit": os.environ.get("SMTC_BEIT_DIR", DATA_PATH + "hub/BEiT/"),
    "deit": os.environ.get("SMTC_DEIT_DIR", DATA_PATH + "hub/DEiT/"),
    "vilt": os.environ.get("SMTC_VILT_DIR", DATA_PATH + "hub/ViLT/"),
    # MMBT's BERT (bert-base-uncased) and LXMERT (unc-nlp/lxmert-base-uncased)
    "mmbt": os.environ.get("SMTC_MMBT_DIR", DATA_PATH + "hub/BERT-base/"),
    "lxmert": os.environ.get("SMTC_LXMERT_DIR", DATA_PATH + "hub/LXMERT/"),
    # a torchvision state dict (.npz or .pth), or a directory holding one
    "resnet50": os.environ.get("SMTC_RESNET50_DIR", DATA_PATH + "hub/ConvModels/resnet50.npz"),
    "resnet152": os.environ.get("SMTC_RESNET152_DIR",
                                DATA_PATH + "hub/ConvModels/resnet152.npz"),
    # the Faster R-CNN's pytorch_model.bin (unc-nlp/frcnn-vg-finetuned), or its directory
    "frcnn": os.environ.get("SMTC_FRCNN_DIR", DATA_PATH + "hub/FRCNN/"),
}


def _column(values: List[str]) -> np.ndarray:
    """One CSV column as pandas' ``read_csv`` types it for these files:
    int64 when every cell is an integer, float64 when every cell is a
    number, else an object array of strings."""
    for kind in (np.int64, np.float64):
        try:
            return np.asarray([kind(v) for v in values], dtype=kind)
        except ValueError:
            pass
    return np.asarray(values, dtype=object)


def read_csv(path: str) -> Dict[str, np.ndarray]:
    """A CSV file with a header row as ``{column: numpy array}``."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _column([r[i] for r in body]) for i, name in enumerate(header)}


class Config:
    """Per-run configuration: task data, labels, aux-loss flags.

    ``Config(args, model_name)`` mirrors the JAX package's
    ``Config.__init__``: the task's data key, the label column (task 2
    argmaxes four one-hot columns, tasks 0/1 rename their task column), batch
    size and number of labels per task, ``max_length`` (40 for ViLT, 128
    otherwise) and the ``loss_str`` artifact tag. ``data`` is a table
    ``{column: numpy array}`` with the columns tweet_id, text, label and
    split."""

    column_names = ["tweet_id", "text", "label", "split"]

    def __init__(self, args, model_name: Optional[str] = None):
        task = args.task
        self.task = task
        self.multilabel = task in {10}
        key = read_csv(PATH[task])
        if task < 2:
            data = {c: key[c] for c in ("tweet_id", "text", "split")}
            data["label"] = key[TASKS[task]]
        elif task == 2:
            data = {c: key[c] for c in ("tweet_id", "text", "split")}
            onehot = np.stack([key[c] for c in (
                "image_adds_text_repr", "image_adds_text_notrepr",
                "image_notadds_text_repr", "image_notadds_text_notrepr")], axis=1)
            data["label"] = np.argmax(onehot, axis=1)
        elif task == 5:
            data = {c: key[c] for c in ("text", "label", "split")}
            data["tweet_id"] = key["id"]
        elif task in (3, 4, 6):
            data = {c: key[c] for c in self.column_names}
        else:
            raise ValueError(f"unknown task {task}")
        self.data = data
        spec = task_spec(task)
        self.num_labels = spec["num_labels"]
        self.batch_size = spec["batch_size"]
        self.img_fmt = IMG_FMT[task]
        self.task_name = TASKS[task]
        self.classes = CLASSES.get(task)
        self.dropout = args.dropout
        self.weight_decay = args.weight_decay
        self.lr = args.lr
        self.max_length = 40 if model_name == "vilt" else 128
        _apply_aux_loss_flags(self, args, multimodal=True)


@dataclasses.dataclass
class ServingConfig:
    """What serving needs of the JAX package's ``Config``: the task's labels
    and the artifact-name tag, without its training data."""

    task: int
    task_name: str
    num_labels: int
    batch_size: int
    img_fmt: str
    classes: Optional[List[str]]
    dropout: float
    max_length: int
    multilabel: bool = False
    use_clip_loss: bool = False
    use_tim_loss: bool = False
    use_iadds_loss: bool = False
    beta_itc: Optional[float] = None
    beta_itm: Optional[float] = None
    beta_iadds: Optional[float] = None
    loss_str: str = ""
    use_loss_correction: bool = False


def _apply_aux_loss_flags(cfg, args, multimodal: bool = True) -> None:
    """Aux-loss flags + the ``loss_str`` artifact tag (part of every
    artifact file name), as the JAX package defines them."""
    cfg.use_clip_loss = False
    cfg.use_tim_loss = False
    cfg.use_iadds_loss = False
    cfg.beta_itc = None
    cfg.beta_itm = None
    cfg.beta_iadds = None
    cfg.loss_str = ""
    if multimodal:
        cfg.use_clip_loss = getattr(args, "use_clip_loss", False)
        cfg.use_tim_loss = getattr(args, "use_tim_loss", False)
        cfg.beta_itc = args.beta_itc if cfg.use_clip_loss else None
        cfg.beta_itm = args.beta_itm if cfg.use_tim_loss else None
        if cfg.use_clip_loss:
            cfg.loss_str += "itc{}".format(cfg.beta_itc)
        if cfg.use_tim_loss:
            cfg.loss_str += "itm{}".format(cfg.beta_itm)
    cfg.use_loss_correction = False


def serving_config(args, model_name=None) -> ServingConfig:
    """The serving configuration of ``args.task`` from the static registry;
    reads no data file."""
    spec = task_spec(args.task)
    cfg = ServingConfig(
        task=args.task,
        task_name=spec["name"],
        num_labels=spec["num_labels"],
        batch_size=spec["batch_size"],
        img_fmt=spec["img_fmt"],
        classes=spec["classes"],
        dropout=getattr(args, "dropout", 0.05),
        max_length=40 if model_name == "vilt" else 128,
    )
    _apply_aux_loss_flags(cfg, args, multimodal=True)
    return cfg


def task_spec(task: int) -> Dict[str, Any]:
    """Static view of a task's registry entry."""
    num_labels = {0: 2, 1: 2, 2: 4, 3: 3, 4: 4, 5: 2, 6: 2}[task]
    batch_size = {0: 8, 1: 8, 2: 8, 3: 16, 4: 8, 5: 16, 6: 16}[task]
    return {
        "task": task,
        "name": TASKS[task],
        "img_fmt": IMG_FMT[task],
        "num_labels": num_labels,
        "batch_size": batch_size,
        "classes": CLASSES.get(task),
    }
