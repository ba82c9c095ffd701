"""The PyTorch port's native image decoder (``<port>/csrc/imgdec.cpp`` through
``data/native.py``) against the JAX package's and against PIL, on the CPU.

The port compiles its own copy of the C++ source (into ``build/imgdec/``, its
file name tagged with the source digest and the host CPU); where it or the
JAX package's decoder does not build, the comparisons with it skip, and a
test says which. Checked: the two decoders give the same bytes on the same
PNG and JPEG files and in-memory bytes; against PIL the JAX package's bounds
hold (PNG exact, full-scale JPEG exact, the triangle resize within 2 LSB, the
DCT-scaled decode of a large JPEG at PSNR >= 45 dB); ``load_pixels_u8``
follows ``SMTC_IMG_DECODER`` with the jpg -> png order; a flag published by
one invocation does not leak into the next; a decode failure is ``None``;
``serve --img_decoder native`` decodes request images as the JAX service
does and answers as it does (float32 within 1e-4).

The JAX package's decoder is built once per module into a directory of this
module's own (``private_jax_decoder``): the JAX package compiles its library
with ``g++ -o`` straight onto one shared path, from whichever process finds it
missing or older than its source, and falls back to PIL without a word when
the build or the load fails. Under ``pytest -n`` another worker (this file,
``test_torch_obj_features.py``, ``test_native_imgdec.py``, ``test_serve.py``)
could then overwrite the library or hand over a half-written one.
"""

import base64
import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from socialmedia_textimage_classification_auxlosses_tpu.cli import _build as JBuild
from socialmedia_textimage_classification_auxlosses_tpu.cli import serve as jserve
from socialmedia_textimage_classification_auxlosses_tpu.data import native as JN
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _common as TCommon
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve as tserve
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
    build_mm_late_setup,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import images as TImages
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import native as TN
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    jax_tree_from_torch,
)

import test_torch_serve
from test_torch_from_jax import to_numpy_tree
from test_torch_serve import BASE, _services, jitted_inits  # noqa: F401 (autouse)


@contextlib.contextmanager
def private_jax_decoder(directory):
    """The JAX package's ``data/native.py`` pointed at a library under
    ``directory``, its loaded library and failure flag reset, and the library
    built and loaded there once; everything restored on exit. No JAX file
    changes: only the module's globals are patched."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_IMGDEC_LIB_PATH",
                   os.path.join(directory, os.path.basename(JN._IMGDEC_LIB_PATH)))
        mp.setattr(JN, "_imgdec_lib", None)
        mp.setattr(JN, "_imgdec_failed", False)
        JN.get_imgdec_lib()
        yield JN


@pytest.fixture(scope="module")
def jax_decoder(tmp_path_factory):
    with private_jax_decoder(str(tmp_path_factory.mktemp("jax_imgdec"))) as jax_native:
        yield jax_native


@pytest.fixture(scope="module")
def port_decoder():
    if not TN.imgdec_available():
        pytest.skip(f"the port's C++ decoder did not build here: {TN.build_error()}")
    return TN


@pytest.fixture(scope="module")
def both(port_decoder, jax_decoder):
    if not jax_decoder.imgdec_available():
        pytest.skip("the JAX package's native decoder did not build here")
    return port_decoder, jax_decoder


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("imgdec")
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (300, 400, 3), np.uint8)
    Image.fromarray(arr).save(tmp / "a.png")
    Image.fromarray(arr).save(tmp / "a.jpg", quality=90)
    # a photo-like JPEG large enough for libjpeg's DCT scaling at 224 px
    base = rng.integers(0, 256, (30, 40, 3), np.uint8)
    big = np.asarray(Image.fromarray(base).resize((2400, 1800), Image.BILINEAR), np.uint8)
    Image.fromarray(big).save(tmp / "big.jpg", quality=90)
    return arr, tmp


@pytest.mark.parametrize("name", ["a.png", "a.jpg", "big.jpg"])
def test_same_bytes_as_the_jax_decoder(both, files, name):
    port, jax_native = both
    path = str(files[1] / name)
    for size in (224, 64):
        np.testing.assert_array_equal(port.native_decode_resize(path, size),
                                      jax_native.native_decode_resize(path, size))
    raw = open(path, "rb").read()
    np.testing.assert_array_equal(port.native_decode_resize_mem(raw, 96),
                                  jax_native.native_decode_resize_mem(raw, 96))
    np.testing.assert_array_equal(port.native_decode_full(path), jax_native.native_decode_full(path))


def test_pil_bounds(port_decoder, files):
    arr, tmp = files
    np.testing.assert_array_equal(port_decoder.native_decode_full(str(tmp / "a.png")), arr)
    pil = np.asarray(Image.open(tmp / "a.jpg").convert("RGB"))
    np.testing.assert_array_equal(port_decoder.native_decode_full(str(tmp / "a.jpg")), pil)
    ref = TImages.resize_to_u8(Image.open(tmp / "a.png").convert("RGB"), 224)
    nat = port_decoder.native_decode_resize(str(tmp / "a.png"), 224)
    assert np.abs(ref.astype(int) - nat.astype(int)).max() <= 2
    ref = TImages.resize_to_u8(Image.open(tmp / "big.jpg").convert("RGB"), 224).astype(float)
    nat = port_decoder.native_decode_resize(str(tmp / "big.jpg"), 224).astype(float)
    psnr = 10 * np.log10(255.0 ** 2 / max(((ref - nat) ** 2).mean(), 1e-9))
    assert psnr >= 45.0, psnr


def test_load_pixels_u8_switch(port_decoder, files, tmp_path, monkeypatch):
    arr, tmp = files
    fmt = str(tmp / "{}.jpg")
    monkeypatch.setenv("SMTC_IMG_DECODER", "pil")
    ref = TImages.load_pixels_u8(fmt, "a", size=224)
    monkeypatch.setenv("SMTC_IMG_DECODER", "native")
    nat = TImages.load_pixels_u8(fmt, "a", size=224)
    np.testing.assert_array_equal(nat, port_decoder.native_decode_resize(str(tmp / "a.jpg"), 224))
    assert np.abs(ref.astype(int) - nat.astype(int)).max() <= 2
    # jpg -> png: only a PNG under the .jpg path format
    Image.fromarray(arr).save(tmp_path / "x.png")
    fmt2 = str(tmp_path / "{}.jpg")
    np.testing.assert_array_equal(TImages.load_pixels_u8(fmt2, "x", size=64),
                                  port_decoder.native_decode_resize(str(tmp_path / "x.png"), 64))
    # the CNN recipe stays PIL under the switch
    crop = TImages.load_pixels_u8(fmt, "a", size=64, center_crop_from=72)
    monkeypatch.setenv("SMTC_IMG_DECODER", "pil")
    np.testing.assert_array_equal(crop, TImages.load_pixels_u8(fmt, "a", size=64,
                                                               center_crop_from=72))


def test_published_flag_does_not_leak(monkeypatch):
    import argparse

    monkeypatch.setenv("SMTC_IMG_DECODER", "pil")
    p = TCommon.add_common_args(argparse.ArgumentParser())
    TCommon.publish_img_decoder(p.parse_args(["--task", "3", "--img_decoder", "native"]))
    assert TImages.native_enabled()
    TCommon.publish_img_decoder(p.parse_args(["--task", "3"]))  # the pil default resets it
    assert os.environ["SMTC_IMG_DECODER"] == "pil" and not TImages.native_enabled()


def test_decode_failure_is_none(port_decoder, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    assert port_decoder.native_decode_resize(str(bad), 224) is None
    assert port_decoder.native_decode_full(str(bad)) is None
    assert port_decoder.native_decode_resize_mem(b"junk", 224) is None
    assert port_decoder.native_decode_resize_mem(b"", 224) is None


def test_native_service_answers_as_the_jax_native_service(both, tmp_path, monkeypatch):
    """The two services over the same weights (``test_torch_serve._services``,
    BERT's tower; the port's random model written as the JAX tree, so the JAX
    builder compiles no initialiser) under ``--img_decoder native``: a
    request image decodes to the same bytes through either service's
    ``_decode_image`` (garbage falls back to PIL, which raises: the
    handler's 400), and the answers agree."""
    argv = [("bert" if a == "bernice" else a) for a in BASE] + ["--img_decoder", "native"]
    monkeypatch.setattr(test_torch_serve, "BASE", argv)
    targs = tserve.parse_args(argv + ["--device", "cpu", "--dtype", "float32"])
    model = build_mm_late_setup(targs, TC.serving_config(targs),
                                generator=torch.Generator().manual_seed(0)).model
    tree = jax.tree_util.tree_map(jax.numpy.asarray, to_numpy_tree(jax_tree_from_torch(model)))
    monkeypatch.setattr(JBuild, "init_mm_late_params", lambda *a, **k: tree)
    jpredict, tpredict, tmeta, _ = _services(tmp_path, "float32")
    size = tmeta["native_size"]
    assert size == tmeta["resize_size"] and size is not None
    rng = np.random.RandomState(3)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (300, 400, 3), np.uint8)).save(buf, "JPEG")
    payload = {"image_b64": base64.b64encode(buf.getvalue()).decode()}
    tpx = tserve._decode_image(payload, None, size)
    jpx = jserve._decode_image(payload, None, size)
    assert isinstance(tpx, np.ndarray) and tpx.shape == (size, size, 3)
    np.testing.assert_array_equal(tpx, jpx)
    window = [("a photo", tpx), ("no photo", None)]
    for a, b in zip(jpredict(window), tpredict(window)):
        assert np.abs(np.array(a["probs"]) - np.array(b["probs"])).max() <= 1e-4
    with pytest.raises(Exception):
        tserve._decode_image({"image_b64": base64.b64encode(b"junk").decode()}, None, size)


def test_native_service_falls_back_with_the_jax_warning(monkeypatch, caplog):
    """Where the decoder does not build, the service decodes with PIL and
    logs the JAX package's warning."""
    monkeypatch.setattr(TN, "imgdec_available", lambda: False)
    _, meta = tserve.build_service(tserve.parse_args(
        BASE + ["--random_init", "--device", "cpu", "--img_decoder", "native"]))
    assert meta["native_size"] is None
    assert "imgdec build unavailable; serving with PIL decode" in caplog.text
