"""The PyTorch port's offline cacher (``cli/obj_features.py``) and LXMERT demo
(``cli/demo_lxmert.py``) against the JAX package's, on the CPU over
``tests/fixtures.py``'s 8 posts: the ``frcnn`` ROI source (``--frcnn_arch
tiny``, a checkpoint written from the torch twin ``tests/ref_frcnn.py``), the
``auto`` / ``dumps`` / ``grid`` sources, the ``mm`` / ``vilt`` image caches and
``--shard``, and the flags that exit.

Tolerances: the two packages' ROI caches hold float16 features, each rounded
from float32 features that agree within 1e-4 of their scale, so within 2e-3
of the scale (one float16 step); boxes within 1e-5; image caches and indices
exactly.
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.cli import obj_features as JObj
from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu.data import cache as JCache
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import demo_lxmert
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import obj_features as TObj
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import cache as TCache
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import frcnn as TF

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture, patch_task  # noqa: E402
from ref_frcnn import TwinFrcnn  # noqa: E402
from test_torch_imgdec import private_jax_decoder  # noqa: E402

TINY = TF.TINY


@pytest.fixture
def task(tmp_path, monkeypatch):
    """The 8-post task-3 fixture, both packages' configs pointed at it, and
    a detector checkpoint from the twin; -> (ids, img_fmt, data dir, ckpt)."""
    csv_path, img_fmt, df = make_task_fixture(tmp_path / "data", task=3, n=8)
    for C in (JC, TC):
        patch_task(monkeypatch, C, 3, csv_path, img_fmt, tmp_path / "results")
    ckpt = tmp_path / "frcnn" / "pytorch_model.bin"
    ckpt.parent.mkdir()
    torch.save(TwinFrcnn(TINY).state_dict(), ckpt)
    return [str(i) for i in df.tweet_id], img_fmt, TC.DATA_PATH, str(ckpt)


def _roi(data, name="mvsa_roi", kind=TCache.RoiFeatureCache):
    return kind(os.path.join(data, "cache", name))


def _same_roi_caches(port, jax_cache, ids, feat_tol=2e-3):
    assert port.index == jax_cache.index
    assert (port.num_boxes, port.feat_dim) == (jax_cache.num_boxes, jax_cache.feat_dim)
    pf, pb = port.gather(ids)
    jf, jb = jax_cache.gather(ids)
    scale = np.abs(jf).max()
    assert scale > 0 and np.abs(pf - jf).max() <= feat_tol * scale
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-5)


def test_frcnn_source_matches_the_jax_cli(task):
    ids, _, data, ckpt = task
    argv = ["--task", "3", "--mode", "obj", "--obj_source", "frcnn", "--frcnn_arch", "tiny",
            "--frcnn_ckpt", ckpt]
    JObj.main(argv)
    jax_cache = _roi(data, kind=JCache.RoiFeatureCache)
    os.rename(jax_cache.cache_dir, jax_cache.cache_dir + "_jax")
    TObj.main(argv + ["--device", "cpu"])
    port = _roi(data)
    assert (port.num_boxes, port.feat_dim) == (TINY.max_detections, TINY.feat_dim)
    assert np.load(os.path.join(port.cache_dir, "features.npy")).dtype == np.float16
    _same_roi_caches(port, _roi(data, "mvsa_roi_jax", JCache.RoiFeatureCache), ids)
    feats, boxes = port.gather(ids)
    assert feats.std(axis=0).any() and (boxes >= 0).all() and (boxes <= 1 + 1e-6).all()


@pytest.mark.parametrize("ingest", ["pil", "device"])
def test_prefetched_chunks_give_the_rows_of_one_batch(task, monkeypatch, caplog, ingest):
    """Chunks of 3 images, each prepared in the thread while the previous
    one runs, fill the cache with the rows of one batch of all 8, and the
    last record carries the timing of every chunk."""
    ids, img_fmt, data, ckpt = task

    def build(name):
        cache = TCache.RoiFeatureCache(os.path.join(data, "cache", name))
        TObj.extract_frcnn_features(ids, img_fmt, cache, weight_path=ckpt, tiny=True,
                                    ingest=ingest, device="cpu")
        return cache.gather(ids)

    whole = build("whole")
    monkeypatch.setattr(TObj, "FRCNN_BATCH", 3)
    with caplog.at_level("INFO", logger=TObj.logger.name):
        chunked = build("chunked")
    for a, b in zip(chunked, whole):
        np.testing.assert_array_equal(a, b)
    timing = [r.frcnn_timing for r in caplog.records if hasattr(r, "frcnn_timing")][-1]
    assert len(timing["batch_s"]) == len(timing["host_s"]) == len(timing["wait_s"]) == 3
    assert timing["images"] == 8 and timing["images_after_first"] == 5
    assert timing["images_per_s_after_first"] > 0 and timing["setup_s"] > 0


def test_auto_takes_the_dumps_then_the_detector(task):
    """``auto``: the reference's dumps when they are there (float32 kept),
    else the detector; ``dumps`` without them exits."""
    ids, _, data, ckpt = task
    with pytest.raises(SystemExit):
        TObj.main(["--task", "3", "--mode", "obj", "--obj_source", "dumps", "--device", "cpu"])
    TObj.main(["--task", "3", "--mode", "obj", "--frcnn_arch", "tiny", "--frcnn_ckpt", ckpt,
               "--device", "cpu"])
    assert _roi(data).feat_dim == TINY.feat_dim
    rng = np.random.RandomState(0)
    feats = rng.randn(len(ids), 3, 6).astype(np.float32)
    boxes = rng.rand(len(ids), 3, 4).astype(np.float32)
    for sub in ("features", "boxes"):
        os.makedirs(os.path.join(data, "mvsa_img_feats", sub))
    for i, data_id in enumerate(ids):
        torch.save(torch.from_numpy(feats[i:i + 1]),
                   os.path.join(data, "mvsa_img_feats", "features", f"feat_{data_id}"))
        torch.save(torch.from_numpy(boxes[i:i + 1]),
                   os.path.join(data, "mvsa_img_feats", "boxes", f"nbox_{data_id}"))
    TObj.main(["--task", "3", "--mode", "obj", "--device", "cpu"])
    got_f, got_b = _roi(data).gather(ids)
    np.testing.assert_array_equal(got_f, feats)
    np.testing.assert_array_equal(got_b, boxes)


def test_grid_source_writes_the_grid(task):
    ids, _, data, _ = task
    TObj.main(["--task", "3", "--mode", "obj", "--obj_source", "grid", "--testing",
               "--device", "cpu"])
    cache = _roi(data)
    feats, boxes = cache.gather(ids)
    assert feats.shape == (len(ids), 49, 2048) and np.isfinite(feats).all()
    np.testing.assert_array_equal(boxes[0], JObj._grid_boxes(7))


def test_device_ingest_and_bf16_through_the_cli(task):
    """``--frcnn_ingest device`` and ``--frcnn_dtype bfloat16`` through the
    command line: close to the PIL float32 cache on average."""
    ids, _, data, ckpt = task
    base = ["--task", "3", "--mode", "obj", "--obj_source", "frcnn", "--frcnn_arch", "tiny",
            "--frcnn_ckpt", ckpt, "--device", "cpu"]
    runs = {}
    for tag, extra in (("pil", []), ("device", ["--frcnn_ingest", "device"]),
                       ("bf16", ["--frcnn_dtype", "bfloat16"])):
        TObj.main(base + extra)
        runs[tag] = _roi(data).gather(ids)[0]
    # mean deltas: a region that the resize or bfloat16 lets another one
    # outrank swaps whole rows
    scale = np.abs(runs["pil"]).max()
    assert np.abs(runs["device"] - runs["pil"]).mean() < 1e-2 * scale
    assert np.abs(runs["bf16"] - runs["pil"]).mean() < 2e-2 * scale


@pytest.mark.parametrize("mode", ["mm", "vilt"])
def test_image_caches_match_the_jax_cli(task, mode):
    ids, _, data, _ = task
    argv = ["--task", "3", "--mode", mode, "--image_size", "40"]
    JObj.main(argv)
    name = "mvsa_u8_40" if mode == "mm" else "mvsa_vilt_u8_40"
    path = os.path.join(data, "cache", name)
    os.rename(path, path + "_jax")
    TObj.main(argv + ["--device", "cpu"])
    port, jax_cache = TCache.ImageCache(path), JCache.ImageCache(path + "_jax")
    assert port.index == jax_cache.index and port.valid.all() and jax_cache.valid.all()
    np.testing.assert_array_equal(port.gather(ids), np.asarray(jax_cache.gather(ids)))


def test_shard_builds_its_slice_then_the_rest_at_first_use(task):
    """``--shard 0:2``: the port's image cache decodes the ids the JAX
    cache decodes, the other rows at their first gather; a second shard in
    the same directory is refused; the ROI cache of a shard holds its
    slice."""
    ids, img_fmt, data, ckpt = task
    argv = ["--task", "3", "--mode", "mm", "--image_size", "40", "--shard", "0:2"]
    JObj.main(argv)
    path = os.path.join(data, "cache", "mvsa_u8_40")
    os.rename(path, path + "_jax")
    TObj.main(argv + ["--device", "cpu"])
    port, jax_cache = TCache.ImageCache(path), JCache.ImageCache(path + "_jax")
    np.testing.assert_array_equal(port.valid, jax_cache.valid)
    assert port.valid.sum() == len(ids) // 2
    full = TCache.ImageCache(os.path.join(data, "full"), size=40).build(ids, img_fmt)
    np.testing.assert_array_equal(port.gather(ids[1:3]), full.gather(ids[1:3]))
    assert TCache.ImageCache(path).valid[port.rows(ids[1:3])].all()  # filled on disk
    with pytest.raises(RuntimeError, match="per-host cache directory"):
        TObj.main(["--task", "3", "--mode", "mm", "--image_size", "40", "--shard", "1:2",
                   "--device", "cpu"])
    TObj.main(["--task", "3", "--mode", "obj", "--obj_source", "frcnn", "--frcnn_arch", "tiny",
               "--frcnn_ckpt", ckpt, "--shard", "1:2", "--device", "cpu"])
    assert sorted(_roi(data, "mvsa_roi_shard1").index) == sorted(ids[1::2])
    with pytest.raises(SystemExit):
        TObj.main(["--task", "3", "--shard", "2:2", "--device", "cpu"])


def test_ids_come_from_the_task_id_column(tmp_path, monkeypatch):
    """``csv`` reads what pandas reads: ``tweet_id``, ``id`` for task 5;
    ``--testing`` takes the first 10."""
    import pandas as pd

    path = tmp_path / "key.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "text", "tweet_id"])
        for i in range(12):
            w.writerow([900 + i, f"t {i}", 5 + i])
    for task in (5, 3):
        monkeypatch.setitem(TC.PATH, task, str(path))
        column = "id" if task == 5 else "tweet_id"
        assert TObj.read_ids(task) == [str(v) for v in pd.read_csv(path)[column].values]


@pytest.fixture(scope="module")
def jax_decoder(tmp_path_factory):
    """The JAX package's decoder built into this module's own directory
    (``test_torch_imgdec.py::private_jax_decoder`` says why)."""
    with private_jax_decoder(str(tmp_path_factory.mktemp("jax_imgdec"))) as jax_native:
        yield jax_native


def test_native_decoder_cache_equals_jax(task, jax_decoder, monkeypatch):
    """``--img_decoder native``: the image cache build goes through the
    port's C++ decoder and equals the JAX package's native build byte for
    byte (one decoder source). Both decoders must be loaded first, so a
    silent fall-back to PIL on either side fails here, by name."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.data import native

    assert native.imgdec_available(), (
        f"the port's C++ decoder did not load ({native.build_error()}): its cache would be PIL's")
    assert jax_decoder.get_imgdec_lib() is not None, (
        "the JAX package's native decoder did not load: its cache would be PIL's")
    ids, _, data, _ = task
    monkeypatch.setenv("SMTC_IMG_DECODER", "pil")  # main() publishes the flag
    argv = ["--task", "3", "--mode", "mm", "--image_size", "40", "--img_decoder", "native"]
    JObj.main(argv)
    path = os.path.join(data, "cache", "mvsa_u8_40")
    os.rename(path, path + "_jax")
    TObj.main(argv + ["--device", "cpu"])
    assert os.environ["SMTC_IMG_DECODER"] == "native"
    port, jax_cache = TCache.ImageCache(path), JCache.ImageCache(path + "_jax")
    np.testing.assert_array_equal(port.gather(ids), np.asarray(jax_cache.gather(ids)))


def test_ensure_roi_cache_returns_the_built_cache(task):
    """The LXMERT builder reads the cache the detector built, untouched."""
    from types import SimpleNamespace

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build_early

    ids, _, data, ckpt = task
    TObj.main(["--task", "3", "--mode", "obj", "--obj_source", "frcnn", "--frcnn_arch", "tiny",
               "--frcnn_ckpt", ckpt, "--device", "cpu"])
    before = os.path.getmtime(os.path.join(data, "cache", "mvsa_roi", "features.npy"))
    want = _roi(data).gather(ids)
    cache = _build_early.ensure_roi_cache(
        SimpleNamespace(arch="tiny"), SimpleNamespace(task_name="mvsa"),
        [SimpleNamespace(ids=np.asarray(ids))], torch.device("cpu"))
    assert os.path.getmtime(os.path.join(data, "cache", "mvsa_roi", "features.npy")) == before
    for a, b in zip(cache.gather(ids), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("source", ["grid", "frcnn"])
def test_demo_lxmert_contract(tmp_path, source):
    """The JAX demo's contract: ``num_labels`` probabilities summing to 1,
    through the grid trunk or the detector."""
    from PIL import Image

    img = tmp_path / "demo.jpg"
    Image.fromarray(np.random.RandomState(1).randint(0, 255, (40, 60, 3), np.uint8)).save(img)
    probs = demo_lxmert.main(["--image", str(img), "--text", "hello @user", "--num_labels", "3",
                              "--arch", "tiny", "--obj_source", source, "--device", "cpu"])
    assert probs.shape == (3,) and abs(probs.sum() - 1.0) < 1e-5 and (probs > 0).all()
