"""The port's image-only runner and the CNN / BEiT late-fusion entry points
on the CPU, on a generated task-3 fixture.

* ``cli/run_img.main`` for a transformer (ViT, 32-px images) and a CNN
  (ResNet-50 cut to one bottleneck in each of two stages, 32 px): the
  artifacts under the JAX runner's names (``{model}_task{t}_seed{s}`` +
  ``_metrics_val.csv``, ``_metrics_test.csv``, ``_net.pth``, ``_preds.csv``,
  checkpoints in ``..._ckpt/``); the ResNet's BatchNorm statistics move in
  training and are carried by ``--ckpt_every`` / ``--resume`` (a resumed
  run ends with the parameters and buffers of an uninterrupted one, bit for
  bit); ``--feature_extract`` trains ``fc`` alone and leaves the trunk and
  its statistics as built; ``--conv_att`` runs.
* ``run_mm_late`` refuses ITC / TIM with a ResNet at parse time, as the
  JAX runner does, and ``--import_reference_ckpt`` with a ResNet.
* ``cli/serve.py`` builds and answers with the BEiT and ResNet towers, a
  ResNet's request images through the centre-crop recipe.
* The centre-crop recipe equals the JAX package's ``resize_to_u8``, and a
  pixel cache that holds every id is read as it is, whatever recipe built
  it (the JAX cache's early return).
"""

import os

import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.data import images as JI
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_img, run_mm_late, serve
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.data import images as TI
from socialmedia_textimage_classification_auxlosses_tpu_torch.data.cache import ImageCache
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import resnet as TR

from fixtures import make_task_fixture

BASE = ["--task", "3", "--arch", "tiny", "--dtype", "float32", "--log_every", "1",
        "--device", "cpu", "--image_size", "32"]
STEM = "{}_task3_seed30"  # JAX cli/run_img.py: f"{model_name}_task{task}_seed{seed}"


def _train(argv):
    """(losses, parameters and buffers after training, as built)."""
    losses, built = [], {}
    real = run_img.build_image_setup

    def build(*a, **k):
        setup = real(*a, **k)
        built.update({n: v.clone() for n, v in setup.model.state_dict().items()})
        return setup

    run_img.build_image_setup = build
    try:
        _, setup = run_img.main(argv, on_step=lambda s, m: losses.append(float(m["loss"])))
    finally:
        run_img.build_image_setup = real
    return losses, {n: v.clone() for n, v in setup.model.state_dict().items()}, built, setup


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_img")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=40)
    hub = root / "hub"
    hub.mkdir()
    (hub / "config.json").write_text('{"image_size": 32, "patch_size": 16}')
    mp = pytest.MonkeyPatch()
    mp.setitem(C.PATH, 3, csv_path)
    mp.setitem(C.IMG_FMT, 3, img_fmt)
    mp.setattr(C, "DATA_PATH", str(root / "data") + os.sep)
    mp.setattr(C, "results_dir_img", str(root / "results") + os.sep)
    mp.setitem(C.MODEL_DIR_DICT, "vit", str(hub) + os.sep)
    mp.setitem(TR.STAGE_SIZES, "resnet50", (1, 1))
    out = {}
    try:
        out["vit"] = _train(BASE + ["--model_name", "vit", "--epochs", "1", "--save_model",
                                    "--save_preds"])
        resnet = BASE + ["--model_name", "resnet50"]
        out["straight"] = _train(resnet + ["--epochs", "2", "--save_model", "--save_preds"])
        _train(resnet + ["--epochs", "1", "--ckpt_every", "1"])
        out["resumed"] = _train(resnet + ["--epochs", "2", "--ckpt_every", "1", "--resume"])
        out["ckpts"] = sorted(os.listdir(C.results_dir_img + STEM.format("resnet50") + "_ckpt"))
        out["feature_extract"] = _train(resnet + ["--epochs", "1", "--feature_extract"])
        out["conv_att"] = _train(resnet + ["--epochs", "1", "--conv_att"])
        out["files"] = sorted(os.listdir(C.results_dir_img))
    finally:
        mp.undo()
    return out


def test_run_img_writes_the_jax_runners_artifacts(runs):
    assert runs["files"] == sorted(
        [STEM.format("vit") + s for s in ("_metrics_test.csv", "_metrics_val.csv", "_net.pth",
                                          "_preds.csv")]
        + [STEM.format("resnet50") + s for s in ("_ckpt", "_metrics_test.csv",
                                                 "_metrics_val.csv", "_net.pth", "_preds.csv")])
    losses, after, built, _ = runs["vit"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not torch.equal(after["tower.encoder.layers.0.attention.query.weight"],
                           built["tower.encoder.layers.0.attention.query.weight"])


def test_resnet_statistics_train_and_resume_carries_them(runs):
    losses, straight, built, _ = runs["straight"]
    stats = [n for n in straight if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 9 and all(not torch.equal(straight[n], built[n]) for n in stats)
    resumed_losses, resumed, _, setup = runs["resumed"]
    assert runs["ckpts"] == ["step_3.pt", "step_4.pt"]
    assert resumed_losses == losses[2:]  # epoch 2 only
    assert set(resumed) == set(straight)
    assert [n for n in straight if not torch.equal(straight[n], resumed[n])] == []


def test_feature_extract_trains_the_head_alone(runs):
    losses, after, built, setup = runs["feature_extract"]
    assert setup.optimizer.names == ["fc.weight", "fc.bias"]
    moved = sorted(n for n in after if not torch.equal(after[n], built[n]))
    assert moved == ["fc.bias", "fc.weight"]  # trunk and BatchNorm statistics as built


def test_conv_att_trains_the_attention_and_its_head(runs):
    losses, after, built, setup = runs["conv_att"]
    assert np.isfinite(losses).all()
    for n in ("self_attn.gamma", "self_attn.query.weight", "fc.weight"):
        assert not torch.equal(after[n], built[n]), n
    # the trunk's unread head gets no gradient but stays in AdamW, as under optax
    # (its decay, lr x wd = 2.5e-9 of a weight a step, is below float32's step)
    assert "trunk.fc.weight" in setup.optimizer.names


@pytest.mark.parametrize("flag", ["--use_clip_loss", "--use_tim_loss"])
def test_cnn_fusion_refuses_the_aux_losses(flag, capsys):
    argv = ["--txt_model_name", "bernice", "--img_model_name", "resnet152", "--fusion_name",
            "concat_cnn", "--task", "3", flag]
    with pytest.raises(SystemExit) as err:
        run_mm_late.parse_args(argv)
    assert err.value.code == 2 and "transformer image tower" in capsys.readouterr().err


def test_cnn_fusion_refuses_a_reference_checkpoint():
    args = run_mm_late.parse_args(["--txt_model_name", "bernice", "--img_model_name",
                                   "resnet50", "--fusion_name", "xatt", "--task", "3",
                                   "--import_reference_ckpt", "mm_model.pth"])
    with pytest.raises(SystemExit, match="ResNet"):
        run_mm_late.check_supported(args)


@pytest.mark.parametrize("tower", [["--img_model_name", "beit", "--fusion_name", "attention"],
                                   ["--img_model_name", "resnet50", "--fusion_name", "xatt"]],
                         ids=["beit", "resnet50"])
def test_serve_answers_with_the_beit_and_resnet_towers(tower, monkeypatch):
    from PIL import Image

    monkeypatch.setitem(TR.STAGE_SIZES, "resnet50", (1, 1))
    args = serve.parse_args(["--task", "3", "--txt_model_name", "bernice", "--arch", "tiny",
                             "--dtype", "float32", "--device", "cpu", "--random_init",
                             "--max_batch", "4"] + tower)
    predict, meta = serve.build_service(args)
    assert meta["center_crop_from"] == (256 if "resnet50" in tower else None)
    photo = Image.fromarray(np.random.RandomState(0).randint(0, 256, (300, 400, 3), np.uint8))
    out = predict([("a post", photo), ("no image", None)])
    probs = np.array([o["probs"] for o in out])
    assert probs.shape == (2, 3) and np.allclose(probs.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("hw", [(300, 400), (500, 260), (256, 256)])
def test_center_crop_recipe_matches_jax(hw):
    from PIL import Image

    img = Image.fromarray(np.random.RandomState(1).randint(0, 256, hw + (3,), np.uint8))
    np.testing.assert_array_equal(TI.resize_to_u8(img, 224, center_crop_from=256),
                                  JI.resize_to_u8(img, 224, center_crop_from=256))
    np.testing.assert_array_equal(TI.resize_to_u8(img, 224), JI.resize_to_u8(img, 224))


def test_a_full_cache_serves_either_recipe(tmp_path):
    """A square-resize cache that holds every id is read as it is by the CNN
    recipe (the JAX cache's early return, kept on purpose); a missing id is
    decoded into it with the recipe asked for."""
    from PIL import Image

    ids = [1, 2]
    fmt = str(tmp_path / "{}.jpg")
    for i in ids + [3]:
        Image.fromarray(np.random.RandomState(i).randint(0, 256, (300, 400, 3),
                                                         np.uint8)).save(fmt.format(i))
    cache_dir = str(tmp_path / "cache")
    square = ImageCache(cache_dir, 32).build(ids, fmt).gather(ids)
    again = ImageCache(cache_dir, 32).build(ids, fmt, center_crop_from=256).gather(ids)
    np.testing.assert_array_equal(again, square)
    grown = ImageCache(cache_dir, 32).build(ids + [3], fmt, center_crop_from=36)
    np.testing.assert_array_equal(grown.gather([3])[0], TI.load_pixels_u8(
        fmt, 3, size=32, center_crop_from=36))
    with open(os.path.join(cache_dir, "meta.json")) as f:
        assert '"center_crop_from": 36' in f.read()
    np.testing.assert_array_equal(grown.gather(ids), square)
