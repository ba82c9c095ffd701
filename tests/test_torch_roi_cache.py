"""The PyTorch port's ROI-feature path for LXMERT against the JAX package's,
on the CPU: ``data/cache.py::RoiFeatureCache`` in both directions (a cache
the JAX class wrote is read unchanged by the port's, and the other way
round; float16 features from our own extractors, the reference's float32
dumps kept bit for bit by ``import_reference_dumps``), the ROI gather of
``data/pipeline.py`` (``roi_features`` / ``roi_boxes`` in each batch, no
pixels with ``with_images=False``), the grid boxes and
``cli/obj_features.py::extract_grid_features`` at ``tiny`` (stages
(1, 1, 1, 1) at 64 px: 2 x 2 regions of 2,048 features) from the JAX
function's own initial trunk, and the order in which
``cli/_build_early.py::ensure_roi_cache`` takes its sources.

Tolerances: gathered features and boxes exactly equal; the grid features,
float32 through a ResNet and then rounded to float16 on both sides, within
1e-3 of their scale.
"""

import csv
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.cli import obj_features as JObj
from socialmedia_textimage_classification_auxlosses_tpu.data import cache as JCache
from socialmedia_textimage_classification_auxlosses_tpu.data import pipeline as JP
from socialmedia_textimage_classification_auxlosses_tpu.data import prep as JPrep
from socialmedia_textimage_classification_auxlosses_tpu.data.tokenizers import (
    build_tokenizer as jax_tokenizer)
from socialmedia_textimage_classification_auxlosses_tpu.models import resnet as JR
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build_early as TBuild
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import obj_features as TObj
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import cache as TCache
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import pipeline as TP
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import prep as TPrep
from socialmedia_textimage_classification_auxlosses_tpu_torch.data.tokenizers import (
    build_tokenizer as port_tokenizer)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    load_jax_params)

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import to_numpy_tree  # noqa: E402

IDS = [str(i) for i in (101, 7, 2024, 55, 3)]


def _features(seed, n=len(IDS), boxes=6, dim=10):
    rng = np.random.RandomState(seed)
    return rng.randn(n, boxes, dim).astype(np.float32) * 3, rng.rand(n, boxes, 4).astype(np.float32)


def _same_gather(a, b, ids):
    fa, ba = a.gather(ids)
    fb, bb = b.gather(ids)
    assert fa.dtype == fb.dtype == ba.dtype == bb.dtype == np.float32
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ba, bb)
    assert (a.num_boxes, a.feat_dim) == (b.num_boxes, b.feat_dim)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    feats, boxes = _features(0)
    kinds = {"jax": JCache.RoiFeatureCache, "port": TCache.RoiFeatureCache}
    reader = "port" if writer == "jax" else "jax"
    written = kinds[writer](str(tmp_path), num_boxes=6, feat_dim=10)
    written.write(IDS, feats, boxes)
    assert np.load(tmp_path / "features.npy").dtype == np.float16
    read = kinds[reader](str(tmp_path))
    assert read.index == written.index
    order = IDS[::-1] + IDS[:2]
    _same_gather(read, written, order)
    np.testing.assert_array_equal(read.gather(order)[0],
                                  feats[[IDS.index(i) for i in order]].astype(np.float16))


def test_reference_dumps_keep_their_float32_bits(tmp_path):
    """Per-sample ``torch.save`` dumps (one (1, boxes, ...) tensor each; one
    id without dumps) imported by both packages: the same cache, float32
    kept, the missing id left out."""
    feats, boxes = _features(1, boxes=4, dim=7)
    for sub in ("features", "boxes"):
        os.makedirs(tmp_path / "data" / "mvsa_img_feats" / sub)
    for i, data_id in enumerate(IDS[:-1]):
        torch.save(torch.from_numpy(feats[i:i + 1]),
                   tmp_path / "data" / "mvsa_img_feats" / "features" / f"feat_{data_id}")
        torch.save(torch.from_numpy(boxes[i:i + 1]),
                   tmp_path / "data" / "mvsa_img_feats" / "boxes" / f"nbox_{data_id}")
    data = str(tmp_path / "data") + os.sep
    port = TCache.RoiFeatureCache(str(tmp_path / "port"))
    jax_cache = JCache.RoiFeatureCache(str(tmp_path / "jax"))
    assert port.import_reference_dumps(data, "mvsa", IDS)
    assert jax_cache.import_reference_dumps(data, "mvsa", IDS)
    assert np.load(tmp_path / "port" / "features.npy").dtype == np.float32
    assert set(port.index) == set(IDS[:-1]) and not port.holds(IDS) and port.holds(IDS[:-1])
    _same_gather(port, jax_cache, IDS[:-1])
    np.testing.assert_array_equal(port.gather(IDS[:-1])[0], feats[:-1])
    assert (port.num_boxes, port.feat_dim) == (4, 7)
    assert not TCache.RoiFeatureCache(str(tmp_path / "none")).import_reference_dumps(
        str(tmp_path / "nowhere") + os.sep, "mvsa", IDS)


def test_pipeline_gathers_roi_features_like_jax(tmp_path):
    """Every batch carries each id's ROI features and boxes, and no pixels."""
    csv_path, img_fmt, df = make_task_fixture(tmp_path / "data", task=3, n=20)
    ids = [str(i) for i in df["tweet_id"]]
    cache_dir = str(tmp_path / "roi")
    TCache.RoiFeatureCache(cache_dir, num_boxes=6, feat_dim=10).write(ids, *_features(2, len(ids)))
    rng = np.random.RandomState(30)
    jtrain = JPrep.prepare_data(df, 3, rng=rng)[0]
    ttrain = TPrep.prepare_data(TC.read_csv(csv_path), 3, rng=np.random.RandomState(30))[0]
    jpipe = JP.SplitPipeline(jtrain, JP.PipelineConfig(batch_size=5, with_images=False),
                             tokenizer=jax_tokenizer("bert", None, 16, 1000),
                             image_source=JP.make_image_source(img_fmt, size=32),
                             roi_cache=JCache.RoiFeatureCache(cache_dir))
    tpipe = TP.SplitPipeline(ttrain, TP.PipelineConfig(batch_size=5, with_images=False),
                             tokenizer=port_tokenizer("bert", None, 16, 1000),
                             image_source=TP.make_image_source(img_fmt, size=32),
                             roi_cache=TCache.RoiFeatureCache(cache_dir))
    jb = list(jpipe.batches(shuffle=True, rng=np.random.RandomState(4)))
    tb = list(tpipe.batches(shuffle=True, rng=np.random.RandomState(4)))
    assert len(tb) == len(jb) == 3
    for w, g in zip(jb, tb):
        assert "pixel_values" not in g and set(g) == set(w)
        for key in ("roi_features", "roi_boxes", "ids", "valid", "data_id"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert g["roi_features"].shape == (5, 6, 10)


@pytest.mark.parametrize("grid", [1, 2, 7])
def test_grid_boxes_match_jax(grid):
    got = TObj._grid_boxes(grid)
    np.testing.assert_array_equal(got, JObj._grid_boxes(grid))
    assert got.shape == (grid * grid, 4) and got.dtype == np.float32


def test_extract_grid_features_tiny_matches_jax(tmp_path, monkeypatch):
    """Both extractors over the fixture's images (one id without an image:
    zeros) from the JAX function's initial trunk, carried into the port; three
    batches of one shape (one JAX compile)."""
    _, img_fmt, df = make_task_fixture(tmp_path / "data", task=3, n=11)
    ids = [str(i) for i in df["tweet_id"]] + ["999"]
    captured = {}
    real_init = JR.ResNet.init

    def capture(self, rng, *a, **k):  # jitted: one compile instead of one per initialiser
        variables = jax.jit(lambda r: real_init(self, r, *a, **k))(rng)
        captured["tree"] = to_numpy_tree(variables)
        return variables

    monkeypatch.setattr(JR.ResNet, "init", capture)
    jcache = JObj.extract_grid_features(ids, img_fmt, JCache.RoiFeatureCache(
        str(tmp_path / "jax")), tiny=True, batch_size=4)
    monkeypatch.setattr(TObj, "init_weights",
                        lambda model, generator: load_jax_params(model, captured["tree"]))
    tcache = TObj.extract_grid_features(ids, img_fmt, TCache.RoiFeatureCache(
        str(tmp_path / "port")), tiny=True, batch_size=4, device="cpu")
    assert (tcache.num_boxes, tcache.feat_dim) == (jcache.num_boxes, jcache.feat_dim) == (4, 2048)
    tf, tb = TCache.RoiFeatureCache(str(tmp_path / "port")).gather(ids)
    jf, jb = jcache.gather(ids)
    np.testing.assert_array_equal(tb, jb)
    assert np.isfinite(tf).all() and np.abs(tf - jf).max() <= 1e-3 * np.abs(jf).max()


def test_grid_fallback_reads_the_pixel_cache_under_use_saved_features(tmp_path, monkeypatch):
    """With ``--use_saved_features`` the grid fallback takes its pixels from
    the uint8 cache ``{task}_u8_{size}`` at the extractor's size (built from
    the images where it lacks an id): the same features as decoding each
    image, the missing image a zero row in both."""
    _, img_fmt, df = make_task_fixture(tmp_path / "data", task=3, n=10)
    ids = [str(i) for i in df["tweet_id"]] + ["999"]
    monkeypatch.setattr(TC, "DATA_PATH", str(tmp_path) + os.sep)
    cfg = SimpleNamespace(task_name="mvsa", img_fmt=img_fmt)
    args = SimpleNamespace(arch="tiny", use_saved_features=True)
    cache = TBuild.ensure_roi_cache(args, cfg, [SimpleNamespace(ids=np.array(ids))], "cpu")
    pixels = TCache.ImageCache(str(tmp_path / "cache" / "mvsa_u8_64"))
    assert pixels.size == 64 and all(i in pixels.index for i in ids)
    assert not pixels.gather(["999"]).any()
    decoded = TObj.extract_grid_features(ids, img_fmt, TCache.RoiFeatureCache(
        str(tmp_path / "decoded")), tiny=True, device="cpu")
    np.testing.assert_array_equal(cache.gather(ids)[0], decoded.gather(ids)[0])
    assert cache.gather(ids)[0][:-1].std(axis=0).max() > 0  # not one image's features


def test_safe_pixels_zeros_a_missing_image_and_raises_without_pil(tmp_path, monkeypatch):
    """An image that does not open is zeros, as in the JAX package; a
    missing PIL is an error, not a blank image."""
    got = TObj._safe_pixels(str(tmp_path / "{}.jpg"), "404", 8)
    assert got.shape == (8, 8, 3) and got.dtype == np.uint8 and not got.any()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        TObj._safe_pixels(str(tmp_path / "{}.jpg"), "404", 8)


def test_ensure_roi_cache_takes_the_first_source_that_works(tmp_path, monkeypatch):
    """A cache holding every id is used as it is; else the reference dumps;
    else grid features are built (on the given device)."""
    monkeypatch.setattr(TC, "DATA_PATH", str(tmp_path) + os.sep)
    cfg = SimpleNamespace(task_name="mvsa", img_fmt="/nowhere/{}.jpg")
    args = SimpleNamespace(arch="tiny", use_saved_features=False)
    splits = [SimpleNamespace(ids=np.array(IDS[:3])), SimpleNamespace(ids=np.array(IDS[3:]))]
    built = []

    def fake_grid(ids, img_fmt, cache, tiny, device, pixel_source):
        assert pixel_source is None  # without --use_saved_features each image is decoded
        built.append((list(ids), tiny, device))
        cache.write(list(ids), *_features(5))
        return cache

    monkeypatch.setattr(TObj, "extract_grid_features", fake_grid)
    cache = TBuild.ensure_roi_cache(args, cfg, splits, "cpu")
    assert built == [(IDS, True, "cpu")] and cache.holds(IDS)
    assert TBuild.ensure_roi_cache(args, cfg, splits, "cpu").holds(IDS) and len(built) == 1
    # a cache missing an id gives way to the reference dumps
    TCache.RoiFeatureCache(str(tmp_path / "cache" / "mvsa_roi")).write(IDS[:2], *_features(6, 2))
    feats, boxes = _features(7, boxes=3, dim=5)
    for sub in ("features", "boxes"):
        os.makedirs(tmp_path / "mvsa_img_feats" / sub)
    for i, data_id in enumerate(IDS):
        torch.save(torch.from_numpy(feats[i:i + 1]),
                   tmp_path / "mvsa_img_feats" / "features" / f"feat_{data_id}")
        torch.save(torch.from_numpy(boxes[i:i + 1]),
                   tmp_path / "mvsa_img_feats" / "boxes" / f"nbox_{data_id}")
    cache = TBuild.ensure_roi_cache(args, cfg, splits, "cpu")
    assert len(built) == 1 and cache.feat_dim == 5
    np.testing.assert_array_equal(cache.gather(IDS)[0], feats)
