"""The PyTorch port's data path against the JAX package's, on the CPU, on the
generated task fixture (``tests/fixtures.py``): ``Config`` reads the data key
with ``csv`` into the same columns pandas gives; ``prepare_data`` picks the
same rows in the same order under ``--testing`` and ``--nsamples`` (the
subsample equals pandas' ``DataFrame.sample``) with the same labels and class
weights; ``SplitPipeline.batches`` yields the same shuffled, padded batches;
and each package reads the uint8 pixel cache the other built. Everything is
compared exactly.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu.data import cache as JCache
from socialmedia_textimage_classification_auxlosses_tpu.data import pipeline as JP
from socialmedia_textimage_classification_auxlosses_tpu.data import prep as JPrep
from socialmedia_textimage_classification_auxlosses_tpu.data.tokenizers import (
    build_tokenizer as jax_tokenizer,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import cache as TCache
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import pipeline as TP
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import prep as TPrep
from socialmedia_textimage_classification_auxlosses_tpu_torch.data.tokenizers import (
    build_tokenizer as port_tokenizer,
)

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402


@pytest.fixture(scope="module")
def task_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    out = {}
    for task, labels in ((3, 3), (6, 2)):
        csv_path, img_fmt, _ = make_task_fixture(root / f"t{task}", task=task, n=40,
                                                 num_labels=labels)
        out[task] = (csv_path, img_fmt, str(root / f"t{task}") + os.sep)
    return out


@pytest.fixture(params=[3, 6])
def configs(request, task_data, monkeypatch):
    task = request.param
    csv_path, img_fmt, data = task_data[task]
    for C in (JC, TC):
        monkeypatch.setitem(C.PATH, task, csv_path)
        monkeypatch.setitem(C.IMG_FMT, task, img_fmt)
        monkeypatch.setattr(C, "DATA_PATH", data)
    args = run_mm_late.parse_args(["--task", str(task), "--use_clip_loss",
                                   "--use_tim_loss", "--device", "cpu"])
    return JC.Config(args), TC.Config(args), img_fmt, data


def test_config_matches_jax(configs):
    jc, tc, _, _ = configs
    for col in ("tweet_id", "text", "label", "split"):
        want = jc.data[col].to_numpy()
        assert tc.data[col].dtype == want.dtype, col
        np.testing.assert_array_equal(tc.data[col], want)
    for attr in ("num_labels", "batch_size", "img_fmt", "task_name", "classes",
                 "max_length", "multilabel", "loss_str", "beta_itc", "beta_itm"):
        assert getattr(tc, attr) == getattr(jc, attr), attr


@pytest.mark.parametrize("n,k,seed", [(40, 40, 0), (40, 10, 3), (200, 37, 30), (7, 7, 1)])
def test_sample_rows_is_pandas_sample(n, k, seed):
    df = pd.DataFrame({"x": np.arange(n)})
    want = df.sample(k, random_state=np.random.RandomState(seed)).index.to_numpy()
    got = TPrep.sample_rows(n, k, np.random.RandomState(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("testing,nsamples", [(False, -1), (True, -1), (False, 10),
                                              (True, 5)])
def test_prepare_data_matches_jax(configs, testing, nsamples):
    jc, tc, _, _ = configs
    want = JPrep.prepare_data(jc.data, jc.num_labels, testing=testing, nsamples=nsamples,
                              task_name=jc.task_name, rng=np.random.RandomState(30))
    got = TPrep.prepare_data(tc.data, tc.num_labels, testing=testing, nsamples=nsamples,
                             rng=np.random.RandomState(30))
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.ids_num, w.ids_num)
        np.testing.assert_array_equal(g.text, w.text)
        np.testing.assert_array_equal(g.labels, w.labels)
    np.testing.assert_array_equal(got[3], want[3])


def test_pixel_cache_is_shared(configs, tmp_path):
    jc, tc, img_fmt, _ = configs
    ids = list(jc.data["tweet_id"].to_numpy()[:6])
    jcache = JCache.ImageCache(str(tmp_path / "jax"), size=32).build(ids, img_fmt)
    np.testing.assert_array_equal(TCache.ImageCache(str(tmp_path / "jax")).gather(ids),
                                  jcache.gather(ids))
    tcache = TCache.ImageCache(str(tmp_path / "port"), size=32).build(ids, img_fmt)
    np.testing.assert_array_equal(JCache.ImageCache(str(tmp_path / "port")).gather(ids),
                                  tcache.gather(ids))
    np.testing.assert_array_equal(tcache.gather(ids), jcache.gather(ids))


def test_pipeline_batches_match_jax(configs, tmp_path):
    jc, tc, img_fmt, data = configs
    jtrain = JPrep.prepare_data(jc.data, jc.num_labels, rng=np.random.RandomState(30))[0]
    ttrain = TPrep.prepare_data(tc.data, tc.num_labels, rng=np.random.RandomState(30))[0]
    cache = str(tmp_path / "cache")
    jsrc = JP.make_image_source(img_fmt, ids=jtrain.ids, size=32, cache_dir=cache,
                                use_cache=True)
    tsrc = TP.make_image_source(img_fmt, ids=ttrain.ids, size=32, cache_dir=cache,
                                use_cache=True)
    bs = 12  # 32 train rows: the last batch is padded
    jpipe = JP.SplitPipeline(jtrain, JP.PipelineConfig(batch_size=bs, image_size=32),
                             tokenizer=jax_tokenizer("bernice", None, 128, 1000),
                             image_source=jsrc)
    tpipe = TP.SplitPipeline(ttrain, TP.PipelineConfig(batch_size=bs, image_size=32),
                             tokenizer=port_tokenizer("bernice", None, 128, 1000),
                             image_source=tsrc)
    assert tpipe.num_batches == jpipe.num_batches == 3
    for shuffle in (False, True):
        jb = list(jpipe.batches(shuffle=shuffle, rng=np.random.RandomState(30)))
        tb = list(tpipe.batches(shuffle=shuffle, rng=np.random.RandomState(30)))
        assert len(tb) == len(jb)
        for w, g in zip(jb, tb):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert tb[-1]["valid"].tolist() == [1.0] * 8 + [0.0] * 4
    dev = TP.to_device(tb[0], "cpu")
    assert dev["ids"].dtype.is_floating_point is False and isinstance(dev["data_id"], np.ndarray)
