"""The PyTorch port's offline data-key builders (``data/keys.py``) and pooling
helpers (``utils/pooling.py``) against the JAX package's, on the CPU.

The five cases of the JAX package's ``tests/test_keys_pooling.py``, each held
against the JAX function on the same input: the builders' tables equal the
JAX DataFrames' columns and their CSV files equal the JAX files byte for
byte; the pooling functions within 1e-6 of JAX's arrays. Besides,
``conv_kernel_summary`` of a tiny ResNet-50 (one bottleneck a stage, with the
conv self-attention head) and of the tiny detector's two stages lists what
the JAX function lists on the JAX trees (shapes from ``jax.eval_shape``: no
initialiser is compiled).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.data import keys as JK
from socialmedia_textimage_classification_auxlosses_tpu.models import frcnn as JF
from socialmedia_textimage_classification_auxlosses_tpu.models import resnet as JR
from socialmedia_textimage_classification_auxlosses_tpu.utils import pooling as JP
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import keys as TK
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import frcnn as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import resnet as TR
from socialmedia_textimage_classification_auxlosses_tpu_torch.utils import pooling as TP


def _same_table(got, want: pd.DataFrame):
    assert list(got) == list(want.columns)
    for column in want.columns:
        assert got[column] == want[column].tolist(), column


def _same_file(port_path, jax_path):
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()


def test_prepare_data_key_mvsa(tmp_path):
    raw = tmp_path / "MVSA-Single" / "data"
    os.makedirs(raw)
    lines = []
    for i in range(20):
        with open(raw / f"{i}.txt", "w", encoding="ISO-8859-1") as f:
            f.write(f"tweet number {i}, caf\xe9 \"quoted\"\n")
        lines.append(f"{i},{i % 3},0,0\n")
    with open(tmp_path / "MVSA-Single" / "valid_pairlist.txt", "w") as f:
        f.writelines(lines)
    want = JK.prepare_data_key_mvsa(str(tmp_path), str(tmp_path / "jax.csv"), seed=0)
    got = TK.prepare_data_key_mvsa(str(tmp_path), str(tmp_path / "port.csv"), seed=0)
    _same_table(got, want)
    _same_file(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert [got["split"].count(s) for s in ("train", "val", "test")] == [16, 2, 2]


def test_prepare_data_key_mhp(tmp_path):
    for split, fname in (("Train", "train"), ("Validation", "dev"), ("Test", "test")):
        d = tmp_path / "MHP" / "Data" / split
        os.makedirs(d)
        pd.DataFrame({
            "image_number": [f"{split}_{i}" for i in range(4)],
            "tweet_text": ["hello", "a, b", "say \"hi\"", "x"],
            "img_text": ["ocr", np.nan, "x", np.nan],
            "Primary_numeric_gt": [0, 1, 2, 3],
        }).to_csv(d / f"dog_whistle_{fname}.csv", index=False)
    want = JK.prepare_data_key_mhp(str(tmp_path), str(tmp_path / "jax.csv"))
    got = TK.prepare_data_key_mhp(str(tmp_path), str(tmp_path / "port.csv"))
    _same_table(got, want)
    _same_file(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert got["text"][:2] == ["helloocr", "a, b"]  # OCR text merged when present


@pytest.mark.parametrize("split_mode", ["random", "files"])
def test_prepare_data_key_tir_comma_repair(tmp_path, split_mode):
    raw = tmp_path / "textimage-data.csv"
    with open(raw, "w") as f:
        f.write("index,tweet_id,tweet,a,b,c,d,e,f\n")
        f.write("0,100,clean tweet,1,0,0,0,1,0\n")
        f.write("1,101,messy, tweet, with, commas,1,0,0,0,1,0\n")
        f.write("2,102,\"quoted, once\",0,1,0,0,1,0\n")
    prefix = str(tmp_path / "ids")
    with open(prefix + "_train.txt", "w") as f:
        f.write("T100\nT102\n")
    with open(prefix + "_test.txt", "w") as f:
        f.write("T101\n")
    kw = dict(split_mode=split_mode, split_files_prefix=prefix, seed=0)
    want = JK.prepare_data_key_tir(str(raw), str(tmp_path / "jax.csv"), **kw)
    got = TK.prepare_data_key_tir(str(raw), str(tmp_path / "port.csv"), **kw)
    _same_table(got, want)
    _same_file(tmp_path / "port.csv", tmp_path / "jax.csv")
    # ", ".join over csv fields that keep their leading spaces, as the reference
    assert got["text"][got["tweet_id"].index("101")] == "messy,  tweet,  with,  commas"


def test_masked_mean_max(rng):
    x = rng.randn(2, 5, 4).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    for name in ("masked_mean", "masked_max"):
        for m in (mask, None):
            want = getattr(JP, name)(jnp.asarray(x), None if m is None else jnp.asarray(m))
            got = getattr(TP, name)(torch.from_numpy(x), None if m is None
                                    else torch.from_numpy(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(TP.masked_mean(torch.from_numpy(x), torch.from_numpy(mask))[0],
                               x[0, :3].mean(axis=0), atol=1e-6)


def test_batch_cosine_similarity(rng):
    a, b = rng.randn(4, 8).astype(np.float32), rng.randn(4, 8).astype(np.float32)
    got = TP.batch_cosine_similarity(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(JP.batch_cosine_similarity(
        jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(TP.batch_cosine_similarity(torch.from_numpy(a),
                                                          torch.from_numpy(a)).numpy(),
                               np.ones(4), atol=1e-6)


def test_conv_kernel_summary_of_a_resnet_matches_jax():
    sizes = (1, 1, 1, 1)  # ResNet-50 at --arch tiny: one bottleneck a stage
    shapes = jax.eval_shape(lambda k: JR.ResNetAttnClassifier(sizes, 3).init(
        k, jnp.zeros((1, 64, 64, 3))), jax.random.PRNGKey(0))
    with torch.device("meta"):  # the module's structure is all the summary reads
        module = TR.ResNetAttnClassifier(sizes, 3)
    got = TP.conv_kernel_summary(module)
    assert got == JP.conv_kernel_summary(shapes)
    assert len(got) == 4 * 4 + 1 + 3  # 3 convs and a projection a block, the stem, q/k/v


def test_conv_kernel_summary_of_the_detector_matches_jax():
    tree = jax.eval_shape(lambda r: JF.FrcnnDetector.init_params(
        SimpleNamespace(cfg=TF.TINY), r), jax.random.PRNGKey(0))
    with torch.device("meta"):
        stages = {"stage1": TF.FrcnnStage1(TF.TINY), "stage2": TF.FrcnnStage2(TF.TINY)}
    for name, stage in stages.items():
        got = TP.conv_kernel_summary(stage)
        assert got and got == JP.conv_kernel_summary(tree[name])
