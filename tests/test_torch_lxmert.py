"""The PyTorch port's LXMERT (``models/lxmert.py``), its importers and its
trainer against the JAX package's, on the CPU.

At a small size (vocab 97, hidden 32, 2 heads, MLP 64, 1 / 1 / 2 language /
vision / cross layers, 5 ROI boxes of 24 features, 3 texts of 12 tokens,
dropout 0), with the JAX parameters drawn from a seed over
``jax.eval_shape`` and carried across by ``models/from_jax.py``:

* ``VisualFeatEmbeddings`` and ``CrossModalityLayer`` (outputs, and the
  gradients of every parameter, the shared cross-attention's summed over
  both directions, and of both inputs) against the JAX modules in float32;
* the classifier's outputs under ``auto`` (JAX ``pallas_interpret``) and
  ``fused`` (JAX ``fused_interpret``), TIM batched and in two passes, in
  float32 and in bfloat16;
* the first train step's loss parts and every gradient (TIM pinned);
* ITC alone: its gradients equal JAX's, and those of the last cross layer's
  language-only parts are zero, because the language states are detached
  before the max-pool;
* the importers (``import_lxmert``, ``import_reference_lxmert``,
  ``maybe_import_lxmert``) on a seeded HF-layout state dict against JAX's,
  and the scanned, padded tree (``stack_lxmert_scan_layers``, two pipeline
  stages) through ``from_jax`` and back;
* ``cli/run_mm_early.main --model lxmert`` end to end on the generated
  task-3 fixture with a seeded ROI cache, against the JAX runner from the
  same initial parameters: every metric within 1e-4, the predictions equal.

Tolerances: float32 outputs 1e-5 of their scale, gradients 1e-4 of each
tensor's scale, losses 1e-5; bfloat16 outputs ``BF16_TOL`` (3e-2) of the larger of
1 and their scale (``test_torch_from_jax.close``): every dense layer rounds
to bfloat16 at other places on each side.
"""

import csv
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.cli import _build_early as JBuild
from socialmedia_textimage_classification_auxlosses_tpu.cli import run_mm_early as JRun
from socialmedia_textimage_classification_auxlosses_tpu.core import config as JC
from socialmedia_textimage_classification_auxlosses_tpu.models import hf_import as JH
from socialmedia_textimage_classification_auxlosses_tpu.models import lxmert as JL
from socialmedia_textimage_classification_auxlosses_tpu.train import losses as JLoss
from socialmedia_textimage_classification_auxlosses_tpu.train import steps as JS
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build_early as TBuild
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_early as TRun
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.data.cache import RoiFeatureCache
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as TH
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import lxmert as TL
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    jax_tree_from_torch, load_jax_params, torch_state_from_jax)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import losses as TLoss
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import optim as TO
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import steps as TS

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_task_fixture  # noqa: E402
from test_torch_from_jax import close, t, to_numpy_tree, torch_cfg  # noqa: E402
from test_torch_resnet import _random_variables  # noqa: E402

B, L, BOXES, FEAT, LABELS, VOCAB = 3, 12, 5, 24, 3, 97
LX = dict(vocab_size=VOCAB, hidden=32, heads=2, mlp_dim=64, max_positions=L, l_layers=1,
          r_layers=1, x_layers=2, visual_feat_dim=FEAT, dropout=0.0)


def _cfgs(attn="auto", dtype="float32"):
    """(JAX config, port config): the JAX side's kernels in interpret mode."""
    jattn = {"auto": "pallas_interpret", "fused": "fused_interpret"}[attn]
    return (JL.LxmertConfig(**LX, dtype=dtype, attn_impl=jattn),
            TL.LxmertConfig(**LX, dtype=dtype, attn_impl=attn))


def _pair(attn="auto", dtype="float32", tim_batched=True):
    jc, tc = _cfgs(attn, dtype)
    return (JL.LxmertClassifier(jc, LABELS, dropout=0.0, tim_batched=tim_batched),
            TL.LxmertClassifier(tc, LABELS, dropout=0.0, tim_batched=tim_batched))


def _carry(params, module):
    return load_jax_params(module.float().eval(), to_numpy_tree(params))


def _scaled_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    if what.endswith("key.bias"):  # its exact gradient is zero: a softmax ignores a shift
        assert np.abs(got).max() <= 1e-5 and np.abs(want).max() <= 1e-5, what
        return
    assert np.abs(got - want).max() <= tol * max(1e-3, np.abs(want).max()), what


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    ids = rng.randint(4, VOCAB, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for i, n in enumerate((L, 7, 4)):
        ids[i, n:] = 0
        mask[i, n:] = 0
    batch = {"ids": ids, "mask": mask, "token_type_ids": np.zeros_like(ids),
             "roi_features": rng.rand(B, BOXES, FEAT).astype(np.float32) * 2,
             "roi_boxes": np.sort(rng.rand(B, BOXES, 4).astype(np.float32), -1),
             "labels": np.eye(LABELS, dtype=np.float32)[[0, 2, 1]],
             "valid": np.array([1, 1, 0], np.float32),
             "tim_src": np.array([1, 2, 2], np.int32),
             "tim_labels": np.array([0, 0, 1], np.int32)}
    jm, _ = _pair()
    a = [jnp.asarray(batch[k]) for k in ("ids", "mask", "token_type_ids", "roi_features",
                                         "roi_boxes")]
    params = _random_variables(jm, *a, tim_ids=a[0], tim_mask=a[1], tim_token_type_ids=a[2],
                               seed=5)
    return params, batch


def _jax_forward(jm, params, batch, tim=None, deterministic=True):
    tim = tim or {}
    return jm.apply(params, batch["ids"], batch["mask"], batch["token_type_ids"],
                    batch["roi_features"], batch["roi_boxes"], tim_ids=tim.get("ids"),
                    tim_mask=tim.get("mask"), tim_token_type_ids=tim.get("token_type_ids"),
                    deterministic=deterministic)


def _jax_outputs(jm, params, batch, tim=None):
    keys = ("out_cls", "logits_per_text", "out_tim", "mm_features")
    fn = jax.jit(lambda p, b, tm: {k: v for k, v in _jax_forward(jm, p, b, tm).items()
                                   if k in keys and v is not None})
    return fn(params, batch, tim)


def _port_forward(tm, batch, tim=None, gen=None):
    tim = tim or {}
    return tm(batch["ids"].long(), batch["mask"], batch["token_type_ids"].long(),
              batch["roi_features"], batch["roi_boxes"],
              tim_ids=None if "ids" not in tim else tim["ids"].long(),
              tim_mask=tim.get("mask"),
              tim_token_type_ids=None if "token_type_ids" not in tim
              else tim["token_type_ids"].long(), gen=gen)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_visual_embeddings_match_jax(data, dtype):
    params, batch = data
    jc, tc = _cfgs(dtype=dtype)
    jm = JL.VisualFeatEmbeddings(jc.encoder_cfg(1), FEAT, 4)
    tm = TL.VisualFeatEmbeddings(tc.encoder_cfg(), FEAT, 4)
    sub = {"params": params["params"]["backbone"]["visual_embeddings"]}
    _carry(sub, tm)
    want = jm.apply(sub, jnp.asarray(batch["roi_features"]), jnp.asarray(batch["roi_boxes"]))
    with torch.no_grad():
        got = tm(t(batch["roi_features"]), t(batch["roi_boxes"]))
    assert got.dtype == torch.float32
    if dtype == "float32":
        _scaled_close(got.numpy(), want, 1e-5, dtype)
    else:
        close(got.numpy(), want, dtype)


def test_cross_modality_layer_outputs_and_gradients_match_jax(data):
    """Outputs and gradients: every parameter (the shared cross-attention
    and ``ln_cross`` summed over both directions) and both inputs."""
    params, _ = data
    rng = np.random.RandomState(11)
    lang = rng.randn(B, L, 32).astype(np.float32)
    vis = rng.randn(B, BOXES, 32).astype(np.float32)
    lmask = np.ones((B, L), np.int32)
    lmask[1, 6:] = 0
    vmask = np.ones((B, BOXES), np.int32)
    wl, wv = rng.randn(B, L, 32).astype(np.float32), rng.randn(B, BOXES, 32).astype(np.float32)
    jc, tc = _cfgs()
    jm = JL.CrossModalityLayer(jc.encoder_cfg(1))
    sub = params["params"]["backbone"]["x_layer_0"]

    def jloss(p, lg, vs):
        lo, vo = jm.apply({"params": p}, lg, vs, jnp.asarray(lmask), jnp.asarray(vmask))
        return jnp.sum(lo * wl) + jnp.sum(vo * wv), (lo, vo)

    (_, (jlo, jvo)), (jgp, jgl, jgv) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                                 has_aux=True))(
        sub, jnp.asarray(lang), jnp.asarray(vis))
    tm = _carry({"params": sub}, TL.CrossModalityLayer(tc.encoder_cfg()))
    tl, tv = t(lang).requires_grad_(), t(vis).requires_grad_()
    lo, vo = tm(tl, tv, t(lmask), t(vmask))
    _scaled_close(lo.detach().numpy(), jlo, 1e-5, "lang")
    _scaled_close(vo.detach().numpy(), jvo, 1e-5, "vis")
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad((lo * t(wl)).sum() + (vo * t(wv)).sum(),
                                list(named.values()) + [tl, tv])
    want = torch_state_from_jax(to_numpy_tree(jgp))
    assert set(want) == set(named)
    for name, g in zip(named, grads):
        _scaled_close(g.numpy(), want[name], 1e-4, name)
    _scaled_close(grads[-2].numpy(), jgl, 1e-4, "d lang")
    _scaled_close(grads[-1].numpy(), jgv, 1e-4, "d vis")


@pytest.fixture(scope="module")
def jax_outputs(data):
    """JAX's outputs under each ``attn``, TIM batched: the TIM rows' values
    do not depend on how they are batched, so both of the port's modes are
    held against them."""
    params, batch = data
    src = batch["tim_src"]
    keys = ("ids", "mask", "token_type_ids")
    return {attn: _jax_outputs(_pair(attn)[0], params,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               {k: jnp.asarray(batch[k][src]) for k in keys})
            for attn in ("auto", "fused")}


@pytest.mark.parametrize("attn", ["auto", "fused"])
@pytest.mark.parametrize("tim_batched", [True, False], ids=["tim_batched", "tim_two_pass"])
def test_classifier_outputs_match_jax(data, jax_outputs, attn, tim_batched):
    params, batch = data
    _, tm = _pair(attn, tim_batched=tim_batched)
    _carry(params, tm)
    src = batch["tim_src"]
    keys = ("ids", "mask", "token_type_ids")
    want = jax_outputs[attn]
    with torch.no_grad():
        got = _port_forward(tm, {k: t(v) for k, v in batch.items()},
                            {k: t(batch[k][src]) for k in keys})
    for key in ("out_cls", "logits_per_text", "out_tim", "mm_features"):
        _scaled_close(got[key].numpy(), want[key], 1e-5, key)
    assert got["out_iadds"] is None


def test_classifier_bf16_matches_jax(data):
    params, batch = data
    jm, tm = _pair(dtype="bfloat16")
    _carry(params, tm)
    want = _jax_outputs(jm, params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = _port_forward(tm, {k: t(v) for k, v in batch.items()})
    for key in ("out_cls", "logits_per_text", "mm_features"):
        close(got[key].numpy(), want[key], "bfloat16")


def _jax_grads(jm, params, batch, loss_kw):
    jcfg = JS.LossConfig(**loss_kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tim, tim_labels = JS._maybe_tim(jcfg, None, jbatch)
    cw = jnp.asarray([1.0, 0.5, 2.0], jnp.float32)
    (_, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JS.assemble_loss(jcfg, _jax_forward(jm, p, jbatch, tim, False), jbatch,
                                   tim_labels, cw), has_aux=True))(params)
    return jparts, torch_state_from_jax(to_numpy_tree(jgrads))


def test_first_step_gradients_match_jax(data):
    """Loss parts and the gradient of every parameter, TIM pinned."""
    params, batch = data
    jm, tm = _pair()
    _carry(params, tm)
    loss_kw = dict(num_labels=LABELS, use_clip_loss=True, use_tim_loss=True,
                   beta_itc=0.1, beta_itm=0.1)
    jparts, jg = _jax_grads(jm, params, batch, loss_kw)
    opt = TO.AdamW(tm.named_parameters(), 1e-3, 0.01)
    step = TS.TrainStep(tm, lambda bt, tim_, gen, det: _port_forward(tm, bt, tim_, gen),
                        TS.LossConfig(**loss_kw), opt, t(np.array([1.0, 0.5, 2.0], np.float32)))
    grads, parts, _ = step.gradients({k: t(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0))
    for key in ("loss", "cls_loss", "itc_loss", "itm_loss"):
        np.testing.assert_allclose(float(parts[key].detach()), float(jparts[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    assert set(grads) == set(jg) and len(grads) == len(list(tm.parameters()))
    for name, g in grads.items():
        _scaled_close(np.zeros_like(jg[name]) if g is None else g.numpy(), jg[name], 1e-4, name)


def test_itc_gradients_hold_the_detach(data):
    """ITC alone: the port's gradients equal JAX's, and the parts of the last
    cross layer that only the language states pass through get none (the
    language side of the max-pool is detached, as in the reference)."""
    params, batch = data
    jm, tm = _pair()
    _carry(params, tm)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    valid = jnp.asarray(batch["valid"])
    jgrads = jax.jit(jax.grad(lambda p: JLoss.clip_loss(
        _jax_forward(jm, p, jb, None, False)["logits_per_text"], valid)))(params)
    want = torch_state_from_jax(to_numpy_tree(jgrads))
    named = dict(tm.named_parameters())
    out = _port_forward(tm, {k: t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(TLoss.clip_loss(out["logits_per_text"], t(batch["valid"])),
                                list(named.values()), allow_unused=True)
    last = f"backbone.x_layers.{LX['x_layers'] - 1}."
    lang_only = [n for n in named if n.startswith(last) and any(
        s in n for s in ("lang_self.", "ln_self_l.", "lang_mlp.", "ln_mlp_l."))]
    assert len(lang_only) == 16
    for name, g in zip(named, grads):
        if name in lang_only:
            assert g is None and not np.abs(want[name]).any(), name
            continue
        _scaled_close(np.zeros_like(want[name]) if g is None else g.numpy(), want[name], 1e-4,
                      name)


# -- the importers ---------------------------------------------------------------------


def _hf_lxmert_state(seed=0, prefix="lxmert."):
    """A seeded state dict under HF ``LxmertModel``'s names (the pooler too,
    which no importer reads)."""
    rng = np.random.RandomState(seed)
    h, m = LX["hidden"], LX["mlp_dim"]
    state = {}

    def lin(name, o, i):
        state[f"{name}.weight"] = rng.randn(o, i).astype(np.float32) * 0.1
        state[f"{name}.bias"] = rng.randn(o).astype(np.float32) * 0.1

    def ln(name):
        state[f"{name}.weight"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
        state[f"{name}.bias"] = rng.randn(h).astype(np.float32) * 0.1

    def attn(p, inner):
        for x in ("query", "key", "value"):
            lin(f"{p}.{inner}.{x}", h, h)
        lin(f"{p}.output.dense", h, h)
        ln(f"{p}.output.LayerNorm")

    for name, n in (("word", VOCAB), ("position", L), ("token_type", 2)):
        state[f"embeddings.{name}_embeddings.weight"] = rng.randn(n, h).astype(np.float32)
    ln("embeddings.LayerNorm")
    lin("encoder.visn_fc.visn_fc", h, FEAT)
    ln("encoder.visn_fc.visn_layer_norm")
    lin("encoder.visn_fc.box_fc", h, 4)
    ln("encoder.visn_fc.box_layer_norm")
    for stack, n in (("layer", LX["l_layers"]), ("r_layers", LX["r_layers"])):
        for i in range(n):
            p = f"encoder.{stack}.{i}"
            attn(f"{p}.attention", "self")
            lin(f"{p}.intermediate.dense", m, h)
            lin(f"{p}.output.dense", h, m)
            ln(f"{p}.output.LayerNorm")
    for i in range(LX["x_layers"]):
        p = f"encoder.x_layers.{i}"
        attn(f"{p}.visual_attention", "att")
        attn(f"{p}.lang_self_att", "self")
        attn(f"{p}.visn_self_att", "self")
        for side in ("lang", "visn"):
            lin(f"{p}.{side}_inter.dense", m, h)
            lin(f"{p}.{side}_output.dense", h, m)
            ln(f"{p}.{side}_output.LayerNorm")
    lin("pooler.dense", h, h)
    return {prefix + k: v for k, v in state.items()}


def _layers():
    return LX["l_layers"], LX["r_layers"], LX["x_layers"]


def test_import_lxmert_matches_jax():
    state = _hf_lxmert_state()
    want = torch_state_from_jax(JH.import_lxmert(dict(state), *_layers()))
    got = torch_state_from_jax(TH.import_lxmert(dict(state), *_layers()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, tm = _pair()
    keys = TH.merge_into(tm, TH.import_lxmert(dict(state), *_layers()), "backbone.")
    assert set(keys) == {n for n in dict(tm.named_parameters()) if n.startswith("backbone.")}


def test_import_reference_lxmert_matches_jax(data):
    """A reference ``Lxmert`` wrapper state dict loads the whole classifier,
    as JAX's importer grafts it."""
    params, _ = data
    state = _hf_lxmert_state(seed=1, prefix="model.")
    rng = np.random.RandomState(2)
    for name, o in (("linear_fusion", 32), ("linear", LABELS), ("linear_tim", 2)):
        state[f"{name}.weight"] = rng.randn(o, 32).astype(np.float32)
        state[f"{name}.bias"] = rng.randn(o).astype(np.float32)
    state["logit_scale"] = np.array(1.5, np.float32)
    jtree = JH.import_reference_lxmert(dict(state), *_layers())
    merged = JH.merge_tower({"root": params["params"]}, jtree, path=("root",))
    _, tm = _pair()
    keys = TH.merge_into(tm, TH.import_reference_lxmert(dict(state), *_layers()))
    assert len(keys) == len(list(tm.parameters()))
    want = torch_state_from_jax(to_numpy_tree(merged["root"]))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_maybe_import_lxmert_from_a_directory_matches_jax(data, tmp_path):
    params, _ = data
    state = _hf_lxmert_state(seed=4)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               tmp_path / "pytorch_model.bin")
    jp = JH.maybe_import_lxmert(params, str(tmp_path), *_layers())
    _, tm = _pair()
    _carry(params, tm)
    assert TH.maybe_import_lxmert(tm, str(tmp_path), *_layers())
    want = torch_state_from_jax(to_numpy_tree(jp))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert TH.maybe_import_lxmert(tm, str(tmp_path / "none"), *_layers()) == []


def test_scanned_padded_tree_loads_and_writes_back(data):
    """The JAX ``--scan_layers`` layout padded for two pipeline stages
    (``lang_layers/layer`` and ``vis_layers/layer`` 1 -> 2, ``x_layers`` 2): the pad slots are dropped and the model equals the unrolled load;
    ``jax_tree_from_torch(scan_layers=True)`` writes the unpadded stacks."""
    params, _ = data
    tree = to_numpy_tree(params)
    padded = dict(tree["params"])
    padded["backbone"] = JH.stack_lxmert_scan_layers(padded["backbone"], *_layers(),
                                                     pipe_stages=2)
    assert padded["backbone"]["vis_layers"]["layer"]["ln_attn"]["scale"].shape[0] == 2
    _, unrolled = _pair()
    _carry(params, unrolled)
    _, scanned = _pair()
    load_jax_params(scanned, {"params": padded})
    for k, v in unrolled.state_dict().items():
        np.testing.assert_array_equal(scanned.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    back = jax_tree_from_torch(scanned, scan_layers=True)["params"]["backbone"]
    want = JH.stack_lxmert_scan_layers(tree["params"]["backbone"], *_layers())
    flat_back = torch_state_from_jax(back)
    flat_want = torch_state_from_jax(want)
    assert set(flat_back) == set(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_back[k], flat_want[k], err_msg=k)
    assert set(jax_tree_from_torch(scanned)["params"]["backbone"]) == set(
        tree["params"]["backbone"])


# -- the trainer end to end ---------------------------------------------------------------

E2E_ARGS = ["--model", "lxmert", "--task", "3", "--epochs", "1", "--seed", "30",
            "--arch", "tiny", "--dtype", "float32", "--dropout", "0", "--use_clip_loss",
            "--evaltest", "--log_every", "100"]
STEM = "lxmert_task3_seed30_itc0.1_"


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners on one fixture, the ROI cache written beforehand (36
    boxes of 16 features from a seed), the port from JAX's initial
    parameters."""
    root = tmp_path_factory.mktemp("e2e_lxmert")
    csv_path, img_fmt, _ = make_task_fixture(root / "data", task=3, n=24)
    data_dir = str(root / "data") + os.sep
    with open(csv_path, newline="") as f:
        ids = [row["tweet_id"] for row in csv.DictReader(f)]
    rng = np.random.RandomState(9)
    cache = RoiFeatureCache(data_dir + "cache/mvsa_roi", num_boxes=36, feat_dim=16)
    cache.write(ids, rng.rand(len(ids), 36, 16) * 3, rng.rand(len(ids), 36, 4))
    hub = root / "hub" / "lxmert"
    hub.mkdir(parents=True)
    (hub / "config.json").write_text(json.dumps({"hidden_dropout_prob": 0.0,
                                                 "vocab_size": 1000}))
    mp = pytest.MonkeyPatch()
    mp.setenv("SMTC_COMPILE_CACHE", "0")
    captured = {}
    real_init = JBuild.init_lxmert_params

    def capture_init(model, *a):  # jitted: one compile instead of one per initialiser
        params = jax.jit(lambda *arrays: real_init(model, *arrays))(*a)
        captured["tree"] = to_numpy_tree(params)
        return params

    try:
        for pkg, C in (("jax", JC), ("torch", TC)):
            mp.setitem(C.PATH, 3, csv_path)
            mp.setitem(C.IMG_FMT, 3, img_fmt)
            mp.setattr(C, "DATA_PATH", data_dir)
            mp.setattr(C, "results_dir_mm_early", str(root / pkg) + os.sep)
            mp.setitem(C.MODEL_DIR_DICT, "lxmert", str(hub) + os.sep)
        mp.setattr(JBuild, "init_lxmert_params", capture_init)
        JRun.main(E2E_ARGS)
        mp.setattr(TBuild, "init_lxmert_weights",
                   lambda model, generator: load_jax_params(model, captured["tree"]))
        TRun.main(E2E_ARGS + ["--device", "cpu"])
        out = {pkg: {s: _read(str(root / pkg / (STEM + s)))
                     for s in ("metrics_val.csv", "metrics_test.csv", "preds.csv")}
               for pkg in ("jax", "torch")}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("table", ["metrics_val.csv", "metrics_test.csv"])
def test_runner_metric_csvs_match_jax(runs, table):
    want, got = runs["jax"][table], runs["torch"][table]
    assert got[0] == want[0] == ["metric", "epoch-1"]
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                               np.array([r[1:] for r in want[1:]], float), rtol=0, atol=1e-4)


def test_runner_predictions_match_jax(runs):
    assert runs["torch"]["preds.csv"] == runs["jax"]["preds.csv"]


def test_unported_lxmert_flags_exit():
    args = TRun.parse_args(E2E_ARGS + ["--device", "cpu", "--remat"])
    with pytest.raises(SystemExit, match="not ported"):
        TRun.check_supported(args)
