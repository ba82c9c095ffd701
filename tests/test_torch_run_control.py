"""The port's run control on the CPU: ``--steps_per_dispatch``,
``--ckpt_every`` / ``--resume``, SIGTERM, ``--profile``, ``--remat``,
``--extract_features`` and ``--eval_txt_test``.

The runs share one generated task-3 fixture (64 train posts: 4 steps an
epoch at batch 16) at ``--arch tiny --dtype float32`` with dropout on
(0.1 in the towers, ``--dropout`` 0.05 in the head) and ITC + TIM, so every
comparison below also holds the generators to the same draws:

* K = 3 against K = 1 (``run_mm_late`` over two epochs, a full chunk and a
  short tail each epoch; ``run_mm_early --model vilt`` over one, the K = 3
  run also under ``--remat``): the same per-step losses and parameters, bit
  for bit (on the CPU both run the same eager step).
* one epoch with ``--ckpt_every 3``, then ``--epochs 2 --resume`` at K = 3:
  the parameters of the straight two-epoch run, bit for bit, and the straight
  run's losses from step 4 on.
* SIGTERM at step 2: a checkpoint of step 2, the run ends there, and a resumed
  run ends with the straight run's parameters.
* ``--profile DIR`` writes a chrome trace in DIR.
* ``--remat`` with dropout on: the text tower's gradients equal those
  without it, bit for bit (the recompute reuses the forward's masks).
* ``--extract_features``: ``features.npz`` holds the test split's fused
  features (hidden 64), labels and ids, as ``preds.csv`` lists them; the
  feature step itself against the JAX ``make_feature_step`` on the same
  parameters (carried with ``from_jax``) within 1e-5 (float32).
* ``--eval_txt_test``: ``preds_txt.csv`` and ``metrics_txt.csv`` for every
  post of the text-only set, with the empty image.
"""

import csv
import glob
import json
import os
import shutil
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.models.vision import (
    vision_encoder_config as jax_vision_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.train import steps as JS
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_early, run_mm_late
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C
from socialmedia_textimage_classification_auxlosses_tpu_torch.data.pipeline import (
    PipelineConfig, SplitPipeline)
from socialmedia_textimage_classification_auxlosses_tpu_torch.data.prep import SplitArrays
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder as TE
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
    TrainCheckpointer)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train.steps import make_feature_step

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import TINY, carry, text_batch, torch_cfg  # noqa: E402

LATE = ["--txt_model_name", "bernice", "--img_model_name", "vit", "--fusion_name",
        "attention", "--task", "3", "--epochs", "2", "--arch", "tiny", "--dtype", "float32",
        "--use_clip_loss", "--use_tim_loss", "--use_saved_features", "--log_every", "1",
        "--device", "cpu"]
VILT = ["--model", "vilt", "--task", "3", "--epochs", "1", "--arch", "tiny", "--dtype",
        "float32", "--use_clip_loss", "--use_tim_loss", "--log_every", "1", "--device", "cpu"]
STEM = "bernice-vit-attention_task3_seed30_itc0.1itm0.1_"
TXT_POSTS = 20


def _train(main, argv, stop_at=None):
    """(losses, global steps seen by ``on_step``, parameters, trainer); with
    ``stop_at`` a SIGTERM is sent to this process after that step."""
    losses, seen = [], []

    def on_step(step, metrics):
        losses.extend(metrics["loss"].reshape(-1).tolist())
        seen.append(step)
        if step == stop_at:
            assert callable(signal.getsignal(signal.SIGTERM)), "no SIGTERM handler"
            os.kill(os.getpid(), signal.SIGTERM)

    trainer, setup = main(argv, on_step=on_step)
    params = {k: v.clone() for k, v in setup.model.state_dict().items()}
    return losses, seen, params, trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_control")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=72)
    data = str(root / "data") + os.sep
    rng = np.random.RandomState(4)
    with open(root / "data" / "text_data_mic.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "text", "label"])
        for i in range(TXT_POSTS):
            w.writerow([5000 + i, f"text only post {i} #tag", rng.randint(0, 3)])
    mp = pytest.MonkeyPatch()
    mp.setitem(C.PATH, 3, csv_path)
    mp.setitem(C.IMG_FMT, 3, img_fmt)
    mp.setattr(C, "DATA_PATH", data)
    mp.setattr(C, "TDATA5", data + "text_data_mic.csv")
    mp.setattr(C, "EMPTY_IMG", data + "MIC/empty_image.png")  # absent: a zero image
    for attr in ("results_dir_mm_late", "results_dir_mm_early"):
        mp.setattr(C, attr, str(root / attr) + os.sep)
    for name in ("bernice", "vit", "vilt"):
        d = root / "hub" / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(
            {"hidden_dropout_prob": 0.1, "vocab_size": 1000, "image_size": 32,
             "patch_size": 16}))
        mp.setitem(C.MODEL_DIR_DICT, name, str(d) + os.sep)
    out = {"root": root}
    try:
        out["late_k1"] = _train(run_mm_late.main, LATE + [
            "--save_preds", "--extract_features", "--eval_txt_test"])
        out["late_k3"] = _train(run_mm_late.main, LATE + ["--steps_per_dispatch", "3"])
        late_1 = [a if a != "2" else "1" for a in LATE]  # --epochs 1
        _train(run_mm_late.main, late_1 + ["--ckpt_every", "3"])
        out["late_resume"] = _train(run_mm_late.main, LATE + [
            "--ckpt_every", "3", "--resume", "--steps_per_dispatch", "3"])
        # a fresh run (no --resume) into a clean checkpoint directory
        shutil.rmtree(C.results_dir_mm_late + STEM + "ckpt")
        profile = str(root / "profile")
        out["sigterm"] = _train(run_mm_late.main, LATE + [
            "--ckpt_every", "100", "--profile", profile], stop_at=2)
        out["sigterm_ckpts"] = sorted(os.listdir(C.results_dir_mm_late + STEM + "ckpt"))
        out["after_sigterm"] = _train(run_mm_late.main, LATE + ["--ckpt_every", "100",
                                                                "--resume"])
        out["traces"] = glob.glob(os.path.join(profile, "*.json"))
        out["vilt_k1"] = _train(run_mm_early.main, VILT)
        out["vilt_k3"] = _train(run_mm_early.main, VILT + ["--steps_per_dispatch", "3",
                                                          "--remat"])
        out["results"] = C.results_dir_mm_late
    finally:
        mp.undo()
    return out


def _same_params(a, b):
    assert a.keys() == b.keys()
    return [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("family", ["late", "vilt"])
def test_chunked_dispatch_follows_the_step_by_step_trajectory(runs, family):
    eager_losses, eager_steps, eager, _ = runs[f"{family}_k1"]
    losses, steps, params, trainer = runs[f"{family}_k3"]
    assert losses == eager_losses
    assert _same_params(params, eager) == []
    # on_step once per chunk: a full chunk of 3, then the epoch's short tail of 1
    assert steps == ([3, 4, 7, 8] if family == "late" else [3, 4])
    assert eager_steps == list(range(1, len(eager_losses) + 1))


def test_resume_ends_with_the_straight_runs_parameters(runs):
    straight_losses, _, straight, _ = runs["late_k1"]
    losses, steps, params, trainer = runs["late_resume"]
    assert steps == [4, 7, 8]  # step 4 ends epoch 1; epoch 2 in chunks of 3 and 1
    assert losses == straight_losses[3:]
    assert _same_params(params, straight) == []
    assert trainer.global_step == 8 and int(trainer.train_step.optimizer.count) == 8


def test_sigterm_saves_and_exits_at_the_step_boundary(runs):
    losses, steps, params, trainer = runs["sigterm"]
    assert steps == [1, 2] and trainer.global_step == 2
    assert runs["sigterm_ckpts"] == ["step_2.pt"]
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # the handler is gone
    resumed_losses, resumed_steps, resumed, _ = runs["after_sigterm"]
    assert resumed_steps == [3, 4, 5, 6, 7, 8]
    assert losses + resumed_losses == runs["late_k1"][0]
    assert _same_params(resumed, runs["late_k1"][2]) == []


def test_profile_writes_a_trace(runs):
    assert len(runs["traces"]) == 1
    with open(runs["traces"][0]) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])


def test_extract_features_writes_the_test_split(runs):
    feats = np.load(runs["results"] + STEM + "features.npz")
    with open(runs["results"] + STEM + "preds.csv", newline="") as f:
        rows = list(csv.reader(f))[1:]
    assert feats["features"].shape == (len(rows), TINY["hidden"])
    assert np.isfinite(feats["features"]).all()
    np.testing.assert_array_equal(feats["data_id"], [int(r[0]) for r in rows])
    np.testing.assert_array_equal(feats["labels"], [int(r[1]) for r in rows])


def test_eval_txt_test_writes_its_artifacts(runs):
    with open(runs["results"] + STEM + "preds_txt.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["data_id", "label", "prediction"]
    assert sorted(int(r[0]) for r in rows[1:]) == list(range(5000, 5000 + TXT_POSTS))
    with open(runs["results"] + STEM + "metrics_txt.csv", newline="") as f:
        table = list(csv.reader(f))
    assert table[0] == ["metric", "result"] and len(table) == 8


def test_feature_step_matches_jax():
    rng = np.random.RandomState(8)
    one = dict(TINY, layers=1)
    text = jax_text_cfg("bernice", None, dtype="float32", dropout=0.1, vocab_size=1000, **one)
    vision = jax_vision_cfg("vit", None, dtype="float32", dropout=0.1, **one)
    kw = dict(fusion_name="attention", patch=16, image_size=32, dropout=0.1)
    jm = JF.MMLateModel(text, vision, 3, **kw)
    tm = TF.MMLateModel(torch_cfg(text), torch_cfg(vision), 3, **kw)
    ids, mask = text_batch(rng, b=4, vocab=1000, pad_id=1)
    px = rng.randn(4, 32, 32, 3).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[[2, 0, 1, 2]]
    params = jax.jit(lambda key: JF.init_mm_late_params(
        jm, key, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(px)))(jax.random.PRNGKey(2))
    carry(params, tm)
    tm.train()  # the feature step must switch to eval mode itself
    jfeat, jlab = JS.make_feature_step(
        lambda p, b, tim, rng_, det: jm.apply(p, b["ids"], b["mask"], b["pixel_values"],
                                              deterministic=det))(
        params, {"ids": jnp.asarray(ids), "mask": jnp.asarray(mask),
                 "pixel_values": jnp.asarray(px), "labels": jnp.asarray(labels)})
    step = make_feature_step(tm, lambda b, tim, gen, det: tm(b["ids"].long(), b["mask"],
                                                             b["pixel_values"]))
    tfeat, tlab = step({"ids": torch.from_numpy(ids), "mask": torch.from_numpy(mask),
                        "pixel_values": torch.from_numpy(px), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))


def test_remat_gradients_equal_the_plain_ones():
    rng = np.random.RandomState(9)
    ids, mask = text_batch(rng, b=3, vocab=1000, pad_id=1)
    grads = {}
    for remat in (False, True):
        cfg = torch_cfg(jax_text_cfg("bernice", None, dtype="float32", dropout=0.1,
                                     vocab_size=1000, remat=remat, **TINY))
        torch.manual_seed(0)
        model = TE.BertEncoder(cfg).train()
        hidden, pooled = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                               gen=torch.Generator().manual_seed(5))
        (hidden.square().mean() + pooled.sum()).backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    assert cfg.remat and all(torch.equal(grads[True][n], g) for n, g in grads[False].items())


def test_checkpointer_keeps_the_newest_two(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "ckpt"), every_steps=2)
    assert ckpt.latest_step() is None and ckpt.restore_latest() is None
    for step in (2, 4, 10):
        ckpt.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert ckpt.steps() == [4, 10]
    state = ckpt.restore_latest()
    assert state["step"] == 10 and torch.equal(state["w"], torch.full((2,), 10.0))


def test_device_iter_chunks_stack_k_batches_and_leave_the_tail_short():
    n = 7
    split = SplitArrays(ids=np.arange(n), ids_num=np.arange(n) + 100,
                        text=np.array([f"post {i}" for i in range(n)], dtype=object),
                        labels=np.eye(2, dtype=np.float32)[np.arange(n) % 2])
    pipe = SplitPipeline(split, PipelineConfig(batch_size=2))
    batches = list(pipe.batches(shuffle=True, rng=np.random.RandomState(1)))
    chunks = list(pipe.device_iter_chunks("cpu", 3, shuffle=True, rng=np.random.RandomState(1)))
    assert [k for _, k in chunks] == [3, 1]
    stacked = [{key: v[i] for key, v in chunk.items()} for chunk, k in chunks for i in range(k)]
    assert len(stacked) == len(batches) == 4
    for got, want in zip(stacked, batches):
        assert isinstance(got["data_id"], np.ndarray)
        for key, value in want.items():
            np.testing.assert_array_equal(np.asarray(got[key]), value)
    skipped = list(pipe.batches(shuffle=True, rng=np.random.RandomState(1), skip=3))
    np.testing.assert_array_equal(skipped[0]["data_id"], batches[3]["data_id"])
