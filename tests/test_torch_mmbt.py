"""The PyTorch port's MMBT (``models/mmbt.py``), its importer and its trainer
against the JAX package's, on the CPU.

At a small size (a BERT of 2 layers, width 64, 2 heads, vocab 1000; a ResNet
trunk of one bottleneck in each of two stages, ``stage_sizes=(1, 1)``, under
a test-only name in both packages' ``STAGE_SIZES``; 3 texts of 12 tokens, so
a joint sequence of 16; 32-px images, a 4 x 4 feature map pooled into 3
overlapping row bins; dropout 0), with the JAX variables (``params`` and
``batch_stats``) drawn from a seed over ``jax.eval_shape`` and carried
across by ``models/from_jax.py``:

* ``adaptive_avg_pool_rows`` (also against torch's ``AdaptiveAvgPool2d``),
  ``split_mmbt_inputs`` and ``TextEmbeddings(word_embeds=...)``;
* the classifier's outputs under ``auto`` (JAX ``pallas_interpret``) and
  ``fused`` (JAX ``fused_interpret``), TIM batched and in two passes, in
  float32 and in bfloat16;
* the first train step (TIM pinned, the trunk's BatchNorm in train mode):
  the loss parts, every gradient, and the running statistics after it
  against flax's mutable ``batch_stats``;
* ``maybe_import_mmbt`` (BERT with its word table moved to the backbone, a
  torchvision ResNet into ``cnn``) against JAX's;
* ``cli/run_mm_early.main --model mmbt`` on the generated fixture: its
  artifacts land under ``results_dir_mmbt``.

Tolerances: float32 outputs 1e-5 of their scale, gradients 1e-4 of each
tensor's scale, losses 1e-5, running statistics 1e-6 absolute plus 1e-6
relative (the batch variance formed in another order); bfloat16 outputs
``BF16_TOL`` (3e-2) of the larger of 1 and their scale
(``test_torch_from_jax.close``).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import encoder as JE
from socialmedia_textimage_classification_auxlosses_tpu.models import hf_import as JH
from socialmedia_textimage_classification_auxlosses_tpu.models import mmbt as JM
from socialmedia_textimage_classification_auxlosses_tpu.models import resnet as JR
from socialmedia_textimage_classification_auxlosses_tpu.train import steps as JS
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_early as TRun
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder as TE
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as TH
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import mmbt as TM
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import resnet as TR
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    load_jax_params, torch_state_from_jax)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim as TO
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import steps as TS

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import close, t, to_numpy_tree, torch_cfg  # noqa: E402
from test_torch_hf_import import bert_state  # noqa: E402
from test_torch_resnet import _random_variables, _torchvision_state  # noqa: E402

B, L, LABELS, PX = 3, 12, 3, 32
CNN = "resnet_test"  # stage_sizes (1, 1), in both packages' STAGE_SIZES for this module


@pytest.fixture(scope="module", autouse=True)
def small_trunk():
    mp = pytest.MonkeyPatch()
    mp.setitem(JR.STAGE_SIZES, CNN, (1, 1))
    mp.setitem(TR.STAGE_SIZES, CNN, (1, 1))
    yield
    mp.undo()


def _enc(attn="pallas_interpret", dtype="float32"):
    return JE.EncoderConfig(vocab_size=1000, hidden=64, layers=2, heads=2, mlp_dim=128,
                            max_positions=32, type_vocab=2, ln_style="post", dropout=0.0,
                            dtype=dtype, attn_impl=attn)


def _pair(attn="auto", dtype="float32", tim_batched=True):
    jattn = {"auto": "pallas_interpret", "fused": "fused_interpret"}[attn]
    jcfg = _enc(jattn, dtype)
    tcfg = dataclasses.replace(torch_cfg(jcfg), attn_impl=attn)
    kw = dict(cnn_name=CNN, dropout=0.0, tim_batched=tim_batched)
    return JM.MmbtClassifier(jcfg, LABELS, **kw), TM.MmbtClassifier(tcfg, LABELS, **kw)


def _carry(variables, module):
    return load_jax_params(module.float().eval(), to_numpy_tree(variables))


def _scaled_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    if what.endswith("key.bias"):  # its exact gradient is zero: a softmax ignores a shift
        assert np.abs(got).max() <= 1e-5 and np.abs(want).max() <= 1e-5, what
        return
    assert np.abs(got - want).max() <= tol * max(1e-3, np.abs(want).max()), what


@pytest.fixture(scope="module")
def data(small_trunk):
    rng = np.random.RandomState(3)
    ids = rng.randint(4, 1000, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for i, n in enumerate((L, 7, 4)):
        ids[i, n - 1] = 3  # the tokenizer's [SEP], the image span's end
        ids[i, n:] = 0
        mask[i, n:] = 0
    ids[:, 0] = 2
    batch = {"ids": ids, "mask": mask,
             "pixel_values": rng.randn(B, PX, PX, 3).astype(np.float32),
             "labels": np.eye(LABELS, dtype=np.float32)[[0, 2, 1]],
             "valid": np.array([1, 1, 0], np.float32),
             "tim_src": np.array([1, 2, 2], np.int32),
             "tim_labels": np.array([0, 0, 1], np.int32)}
    jm, _ = _pair()
    a = [jnp.asarray(batch[k]) for k in ("ids", "mask", "pixel_values")]
    variables = _random_variables(jm, *a, tim_ids=a[0], tim_mask=a[1], seed=5)
    return variables, batch


def _jax_forward(jm, variables, batch, tim=None, train=False):
    tim = tim or {}
    kw = dict(tim_ids=tim.get("ids"), tim_mask=tim.get("mask"))
    if not train:
        return jm.apply(variables, batch["ids"], batch["mask"], batch["pixel_values"], **kw)
    out, upd = jm.apply(variables, batch["ids"], batch["mask"], batch["pixel_values"],
                        deterministic=False, train=True, mutable=["batch_stats"], **kw)
    return dict(out, batch_stats=upd["batch_stats"])


def _port_forward(tm, batch, tim=None, gen=None, train=False):
    tim = tim or {}
    return tm(batch["ids"].long(), batch["mask"], batch["pixel_values"],
              None if "ids" not in tim else tim["ids"].long(), tim.get("mask"),
              train=train, gen=gen)


@pytest.mark.parametrize("h,n", [(4, 3), (7, 3), (7, 1), (5, 5), (2, 3)])
def test_adaptive_avg_pool_rows_matches_jax_and_torch(h, n):
    fmap = np.random.RandomState(h * 10 + n).randn(2, h, 3, 8).astype(np.float32)
    got = TM.adaptive_avg_pool_rows(t(fmap), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(JM.adaptive_avg_pool_rows(
        jnp.asarray(fmap), n)), rtol=0, atol=1e-6)
    ref = torch.nn.AdaptiveAvgPool2d((n, 1))(t(fmap).permute(0, 3, 1, 2))[..., 0]
    np.testing.assert_allclose(got.numpy(), ref.transpose(1, 2).numpy(), rtol=0, atol=1e-6)


def test_split_mmbt_inputs_matches_jax(data):
    _, batch = data
    mask = batch["mask"].copy()
    mask[2] = 0  # a row with no valid token: its end token is the first
    want = JM.split_mmbt_inputs(jnp.asarray(batch["ids"]), jnp.asarray(mask))
    got = TM.split_mmbt_inputs(t(batch["ids"]).long(), t(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_embeddings_take_word_embeds(dtype):
    """``word_embeds`` replaces the word lookup (the JAX module's argument);
    a module without a word table holds only positions, types and the
    LayerNorm."""
    cfg = _enc(dtype=dtype)
    rng = np.random.RandomState(1)
    we = rng.randn(2, 9, 64).astype(np.float32)
    tt = rng.randint(0, 2, (2, 9)).astype(np.int32)
    pos = jnp.zeros((2, 9), jnp.int32)
    jm = JE.TextEmbeddings(cfg)
    variables = _random_variables(jm, pos, jnp.asarray(tt), None, True,
                                  word_embeds=jnp.asarray(we), seed=2)
    assert "word" not in variables["params"]
    tm = _carry(variables, TE.TextEmbeddings(torch_cfg(cfg), word_table=False))
    want = jm.apply(variables, pos, jnp.asarray(tt), None, True, word_embeds=jnp.asarray(we))
    with torch.no_grad():
        got = tm(torch.zeros(2, 9, dtype=torch.long), t(tt).long(), word_embeds=t(we))
    if dtype == "float32":
        _scaled_close(got.numpy(), want, 1e-6, dtype)
    else:
        close(got.numpy(), want, dtype)


@pytest.fixture(scope="module")
def jax_outputs(data):
    """JAX's outputs under each ``attn``, TIM batched: the TIM rows' values
    do not depend on how they are batched, so both of the port's modes are
    held against them."""
    variables, batch = data
    src = batch["tim_src"]
    out = {}
    for attn in ("auto", "fused"):
        jm = _pair(attn)[0]
        out[attn] = jax.jit(lambda v, b, tim: _jax_forward(jm, v, b, tim))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()},
            {k: jnp.asarray(batch[k][src]) for k in ("ids", "mask")})
    return out


@pytest.mark.parametrize("attn", ["auto", "fused"])
@pytest.mark.parametrize("tim_batched", [True, False], ids=["tim_batched", "tim_two_pass"])
def test_classifier_outputs_match_jax(data, jax_outputs, attn, tim_batched):
    variables, batch = data
    _, tm = _pair(attn, tim_batched=tim_batched)
    _carry(variables, tm)
    src = batch["tim_src"]
    want = jax_outputs[attn]
    with torch.no_grad():
        got = _port_forward(tm, {k: t(v) for k, v in batch.items()},
                            {k: t(batch[k][src]) for k in ("ids", "mask")})
    for key in ("out_cls", "logits_per_text", "out_tim", "mm_features"):
        _scaled_close(got[key].numpy(), want[key], 1e-5, key)
    assert got["out_iadds"] is None


def test_classifier_bf16_matches_jax(data):
    variables, batch = data
    jm, tm = _pair(dtype="bfloat16")
    _carry(variables, tm)
    want = jax.jit(lambda v, b: _jax_forward(jm, v, b))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = _port_forward(tm, {k: t(v) for k, v in batch.items()})
    for key in ("out_cls", "logits_per_text", "mm_features"):
        close(got[key].numpy(), want[key], "bfloat16")


def test_first_step_gradients_and_batch_stats_match_jax(data):
    """Loss parts, every parameter's gradient (the trunk's ``fc``, whose
    output nothing reads, none) and the BatchNorm running statistics after
    the train-mode step, against flax's ``batch_stats``."""
    variables, batch = data
    jm, tm = _pair()
    _carry(variables, tm)
    loss_kw = dict(num_labels=LABELS, use_clip_loss=True, use_tim_loss=True,
                   beta_itc=0.1, beta_itm=0.1)
    cw = np.array([1.0, 0.5, 2.0], np.float32)
    jcfg = JS.LossConfig(**loss_kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tim, tim_labels = JS._maybe_tim(jcfg, None, jbatch)

    def loss(params):
        out = _jax_forward(jm, {"params": params, "batch_stats": variables["batch_stats"]},
                           jbatch, tim, train=True)
        total, parts = JS.assemble_loss(jcfg, out, jbatch, tim_labels, jnp.asarray(cw))
        return total, (parts, out["batch_stats"])

    (_, (jparts, jstats)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    opt = TO.AdamW(tm.named_parameters(), 1e-3, 0.01)
    step = TS.TrainStep(tm, lambda bt, tim_, gen, det: _port_forward(tm, bt, tim_, gen,
                                                                     train=not det),
                        TS.LossConfig(**loss_kw), opt, t(cw))
    grads, parts, _ = step.gradients({k: t(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0))
    for key in ("loss", "cls_loss", "itc_loss", "itm_loss"):
        np.testing.assert_allclose(float(parts[key].detach()), float(jparts[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    want = torch_state_from_jax({"params": to_numpy_tree(jgrads)})
    assert set(grads) == set(want) and len(grads) == len(list(tm.parameters()))
    unused = sorted(n for n, g in grads.items() if g is None)
    assert unused == ["backbone.cnn.fc.bias", "backbone.cnn.fc.weight"]
    for name, g in grads.items():
        _scaled_close(np.zeros_like(want[name]) if g is None else g.numpy(), want[name], 1e-4,
                      name)
    stats = torch_state_from_jax({"params": {}, "batch_stats": to_numpy_tree(jstats)})
    assert len(stats) == 2 * (1 + 3 * 2 + 2)  # stem, three per block, two downsamples
    before = torch_state_from_jax({"params": {},
                                   "batch_stats": to_numpy_tree(variables["batch_stats"])})
    for k, v in stats.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v, atol=1e-6, rtol=1e-6,
                                   err_msg=k)
        assert np.abs(v - before[k]).max() > 1e-4, f"{k} did not move"


def test_maybe_import_mmbt_matches_jax(data, tmp_path):
    """BERT from the model directory (its word table into ``backbone.word``)
    and the torchvision ResNet into ``backbone.cnn``, statistics included."""
    variables, _ = data
    bert = dict(bert_state(6, pre="bert.", positions=32, type_vocab=2))
    torch.save({k: torch.from_numpy(v) for k, v in bert.items()}, tmp_path / "pytorch_model.bin")
    cnn = _torchvision_state(seed=3, sizes=(1, 1))
    np.savez(tmp_path / "cnn.npz", **cnn)
    jv = JH.maybe_import_mmbt(variables, str(tmp_path), 2,
                              cnn_weight_path=str(tmp_path / "cnn.npz"), cnn_name=CNN)
    _, tm = _pair()
    _carry(variables, tm)
    keys = TH.maybe_import_mmbt(tm, str(tmp_path), 2, cnn_weight_path=str(tmp_path / "cnn.npz"),
                                cnn_name=CNN)
    assert "backbone.word.weight" in keys and "backbone.cnn.stem_bn.running_var" in keys
    assert not any(k.startswith(("backbone.img_proj", "linear", "backbone.cnn.fc"))
                   for k in keys)
    want = torch_state_from_jax(to_numpy_tree(jv))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_runner_writes_under_results_dir_mmbt(tmp_path, monkeypatch):
    """``run_mm_early --model mmbt`` at ``--arch tiny`` (ResNet-50, 32 px by
    ``--image_size``): the artifacts under ``results_dir_mmbt``, none under
    ``results_dir_mm_early``; finite metrics."""
    csv_path, img_fmt, _ = make_task_fixture(tmp_path / "data", task=3, n=24)
    monkeypatch.setitem(TC.PATH, 3, csv_path)
    monkeypatch.setitem(TC.IMG_FMT, 3, img_fmt)
    monkeypatch.setattr(TC, "DATA_PATH", str(tmp_path / "data") + os.sep)
    monkeypatch.setattr(TC, "results_dir_mm_early", str(tmp_path / "early") + os.sep)
    monkeypatch.setattr(TC, "results_dir_mmbt", str(tmp_path / "mmbt") + os.sep)
    trainer, setup = TRun.main(["--model", "mmbt", "--task", "3", "--epochs", "1",
                                "--arch", "tiny", "--dtype", "float32", "--image_size", "32",
                                "--use_clip_loss", "--use_tim_loss", "--save_model",
                                "--device", "cpu"])
    stem = "mmbt_task3_seed30_itc0.1itm0.1_"
    assert sorted(os.listdir(tmp_path / "mmbt")) == [
        stem + s for s in ("metrics_test.csv", "metrics_val.csv", "net.pth")]
    assert not os.path.exists(tmp_path / "early")
    assert isinstance(setup.model, TM.MmbtClassifier)
    with open(tmp_path / "mmbt" / (stem + "metrics_test.csv")) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    assert all(np.isfinite(float(r[1])) for r in rows)


def test_import_reference_ckpt_is_refused_for_mmbt():
    args = TRun.parse_args(["--model", "mmbt", "--task", "3", "--device", "cpu",
                            "--import_reference_ckpt", "x.pth"])
    with pytest.raises(SystemExit, match="no MMBT model"):
        TRun.check_supported(args)
