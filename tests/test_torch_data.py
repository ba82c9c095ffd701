"""The PyTorch port's data path against the JAX package's, on the CPU, on the
generated task fixture (``tests/fixtures.py``): ``Config`` reads the data key
with ``csv`` into the same columns pandas gives; ``prepare_data`` picks the
same rows in the same order under ``--testing`` and ``--nsamples`` (the
subsample equals pandas' ``DataFrame.sample``) with the same labels and class
weights; ``SplitPipeline.batches`` yields the same shuffled, padded batches;
each package reads the uint8 pixel cache the other built; and ViLT's exact
resize (``--vilt_exact_resize``) gives the same geometry, frames and extents.
Everything is compared exactly.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu.data import cache as JCache
from socialmedia_textimage_classification_auxlosses_tpu.data import images as JImages
from socialmedia_textimage_classification_auxlosses_tpu.data import pipeline as JP
from socialmedia_textimage_classification_auxlosses_tpu.data import prep as JPrep
from socialmedia_textimage_classification_auxlosses_tpu.data.tokenizers import (
    build_tokenizer as jax_tokenizer,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import cache as TCache
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import images as TImages
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


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (720, 1280), (500, 500), (100, 3000),
                                (3000, 90), (31, 31), (384, 385)], ids=str)
def test_vilt_exact_geometry_matches_jax(hw):
    assert TImages.vilt_exact_geometry(*hw) == JImages.vilt_exact_geometry(*hw)
    assert TImages.vilt_canvas() == JImages.vilt_canvas() == 608


def test_exact_vilt_source_and_batches_match_jax(configs, tmp_path):
    """``--vilt_exact_resize``: the same frames and extents for photos of
    several aspects (and the zero frame of extent 384 for one that does not
    open), and the pipeline puts the extents in the batch as ``grid_hw``."""
    from PIL import Image

    jc, tc, _, _ = configs
    train = TPrep.prepare_data(tc.data, tc.num_labels, rng=np.random.RandomState(30))[0]
    rng = np.random.RandomState(5)
    sizes = [(480, 640), (640, 480), (720, 1280), (500, 500)]
    img_fmt = str(tmp_path / "{}.jpg")
    for i, data_id in enumerate(train.ids[:-1]):  # the last id has no file
        h, w = sizes[i % len(sizes)]
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(img_fmt.format(data_id))
    jsrc, tsrc = JP.ExactViltImageSource(img_fmt), TP.ExactViltImageSource(img_fmt)
    jf, jg = jsrc.gather(list(train.ids))
    tf, tg = tsrc.gather(list(train.ids))
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tg, jg)
    assert tg.dtype == np.int32 and tg[-1].tolist() == [384, 384] and not tf[-1].any()
    assert {tuple(g) for g in tg[:-1]} == {JImages.vilt_exact_geometry(*s) for s in sizes}
    cfg = TP.PipelineConfig(batch_size=12, max_length=40, image_size=608)
    pipe = TP.SplitPipeline(train, cfg, tokenizer=port_tokenizer("bert", None, 40, 1000),
                            image_source=tsrc)
    for batch in pipe.batches(shuffle=False):
        assert batch["pixel_values"].shape == (12, 608, 608, 3)
        assert batch["grid_hw"].shape == (12, 2) and batch["token_type_ids"].shape == (12, 40)
    dev = TP.to_device(batch, "cpu")
    assert dev["grid_hw"].dtype == torch.int32
