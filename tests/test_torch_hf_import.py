"""PyTorch port's checkpoint import (``models/hf_import.py``) against the JAX
package's, on the CPU at the tiny size (2 layers of width 64).

Hugging Face-named state dicts are made from numpy with a seed (BERT with its
``bert.`` scope, RoBERTa with ``roberta.``, Bernice / XLM-R without, ViT,
DeiT with its distillation token, ViLT, a reference-trained ``MM_Model`` for
each of the four fusion heads and a reference ``ViLT``), imported by both
packages, and the JAX forward is held against the port's on the same inputs
(float32, 1e-4; the JAX forwards run under ``jax.jit``, which compiles a tiny model
faster than eager dispatch does). The port's own safetensors reader is held against files the
``safetensors`` package writes, and the late-fusion builder is shown to load
the vision tower from a checkpoint directory instead of leaving it random.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import encoder as JE
from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models import hf_import as JH
from socialmedia_textimage_classification_auxlosses_tpu.models import vilt as JV
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.models.vision import (
    vision_encoder_config as jax_vision_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import encoder as TE
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as TH
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import vilt as TV

from test_torch_from_jax import TINY, close, j, t, text_batch, torch_cfg
from test_torch_vilt import _port_forward as vilt_port_forward

HID, LAYERS, MLP, VOCAB, LABELS = TINY["hidden"], TINY["layers"], TINY["mlp_dim"], 1000, 3


class _State(dict):
    """A HF-named state dict filled from a numpy generator."""

    def __init__(self, seed, hid=HID, mlp=MLP):
        super().__init__()
        self.rng = np.random.RandomState(seed)
        self.hid, self.mlp_dim = hid, mlp

    def arr(self, key, *shape, scale=0.05, offset=0.0):
        self[key] = (offset + scale * self.rng.randn(*shape)).astype(np.float32)

    def dense(self, key, out, inp, bias=True):
        self.arr(f"{key}.weight", out, inp, scale=inp ** -0.5)
        if bias:
            self.arr(f"{key}.bias", out)

    def ln(self, key):
        self.arr(f"{key}.weight", self.hid, scale=0.1, offset=1.0)
        self.arr(f"{key}.bias", self.hid, scale=0.1)

    def mlp(self, p):
        self.dense(f"{p}.intermediate.dense", self.mlp_dim, self.hid)
        self.dense(f"{p}.output.dense", self.hid, self.mlp_dim)

    def vit_layers(self, pre):
        for i in range(LAYERS):
            p = f"{pre}encoder.layer.{i}"
            for name in ("query", "key", "value"):
                self.dense(f"{p}.attention.attention.{name}", self.hid, self.hid)
            self.dense(f"{p}.attention.output.dense", self.hid, self.hid)
            self.ln(f"{p}.layernorm_before")
            self.ln(f"{p}.layernorm_after")
            self.mlp(p)


def bert_state(seed, pre="", positions=514, type_vocab=1):
    s = _State(seed)
    s.arr(f"{pre}embeddings.word_embeddings.weight", VOCAB, HID, scale=0.5)
    s.arr(f"{pre}embeddings.position_embeddings.weight", positions, HID, scale=0.5)
    s.arr(f"{pre}embeddings.token_type_embeddings.weight", type_vocab, HID, scale=0.5)
    s.ln(f"{pre}embeddings.LayerNorm")
    s[f"{pre}embeddings.position_ids"] = np.arange(positions, dtype=np.int64)[None]
    for i in range(LAYERS):
        p = f"{pre}encoder.layer.{i}"
        for name in ("query", "key", "value"):
            s.dense(f"{p}.attention.self.{name}", HID, HID)
        s.dense(f"{p}.attention.output.dense", HID, HID)
        s.ln(f"{p}.attention.output.LayerNorm")
        s.mlp(p)
        s.ln(f"{p}.output.LayerNorm")
    s.dense("pooler.dense" if pre == "bert." else f"{pre}pooler.dense", HID, HID)
    return s


def vit_state(seed, pre="", image_size=32, patch=16, distilled=False):
    s = _State(seed)
    s.arr(f"{pre}embeddings.cls_token", 1, 1, HID, scale=0.5)
    if distilled:
        s.arr(f"{pre}embeddings.distillation_token", 1, 1, HID, scale=0.5)
    n = (image_size // patch) ** 2 + 1 + distilled
    s.arr(f"{pre}embeddings.position_embeddings", 1, n, HID, scale=0.5)
    s.arr(f"{pre}embeddings.patch_embeddings.projection.weight", HID, 3, patch, patch,
          scale=(3 * patch * patch) ** -0.5)
    s.arr(f"{pre}embeddings.patch_embeddings.projection.bias", HID)
    s.vit_layers(pre)
    s.ln(f"{pre}layernorm")
    s.dense(f"{pre}pooler.dense", HID, HID)
    return s


def vilt_state(seed, pre, cfg, side=12):
    s = _State(seed, cfg.hidden, cfg.mlp_dim)
    e = f"{pre}embeddings."
    s.arr(e + "text_embeddings.word_embeddings.weight", cfg.vocab_size, cfg.hidden, scale=0.5)
    s.arr(e + "text_embeddings.position_embeddings.weight", cfg.max_positions, cfg.hidden,
          scale=0.5)
    s.arr(e + "text_embeddings.token_type_embeddings.weight", 2, cfg.hidden, scale=0.5)
    s.ln(e + "text_embeddings.LayerNorm")
    s.arr(e + "patch_embeddings.projection.weight", cfg.hidden, 3, 32, 32, scale=0.02)
    s.arr(e + "patch_embeddings.projection.bias", cfg.hidden)
    s.arr(e + "cls_token", 1, 1, cfg.hidden, scale=0.5)
    s.arr(e + "position_embeddings", 1, side * side + 1, cfg.hidden, scale=0.5)
    s.arr(e + "token_type_embeddings.weight", 2, cfg.hidden, scale=0.5)
    s.vit_layers(pre)
    s.ln(f"{pre}layernorm")
    s.dense(f"{pre}pooler.dense", cfg.hidden, cfg.hidden)
    return s


def _encode_text(cfg_name, seed, pre):
    type_vocab = 2 if cfg_name == "bert" else 1
    positions = 512 if cfg_name == "bert" else 514
    state = bert_state(seed, pre, positions, type_vocab)
    jcfg = jax_text_cfg(cfg_name, None, vocab_size=VOCAB, **TINY)
    rng = np.random.RandomState(seed)
    ids, mask = text_batch(rng, vocab=VOCAB, pad_id=jcfg.pad_token_id)
    jm = JE.BertEncoder(jcfg)  # the imported tree is the whole tower: no init needed
    jout = jax.jit(jm.apply)({"params": JH.import_bert_tower(dict(state), LAYERS)},
                             j(ids, jnp.int32), j(mask, jnp.int32))
    tm = TE.BertEncoder(torch_cfg(jcfg)).eval()
    keys = TH.merge_into(tm, TH.import_bert_tower(dict(state), LAYERS))
    with torch.no_grad():
        tout = tm(t(ids).long(), t(mask))
    return state, tm, keys, jout, tout


@pytest.mark.parametrize("name,pre", [("bert", "bert."), ("roberta", "roberta."),
                                      ("bernice", "")])
def test_text_tower_import_matches_jax(name, pre):
    state, tm, keys, jout, tout = _encode_text(name, 5, pre)
    assert len(keys) == len(tm.state_dict())  # every parameter came from the file
    for a, b in zip(tout, jout):
        close(a, b, "float32")
    w = state[f"{pre}encoder.layer.1.attention.self.query.weight"]
    np.testing.assert_array_equal(tm.encoder.layers[1].attention.query.weight.detach().numpy(), w)


@pytest.mark.parametrize("distilled", [False, True], ids=["vit", "deit"])
def test_vision_tower_import_matches_jax(distilled):
    state = vit_state(6, "vit." if not distilled else "", distilled=distilled)
    prefix = 2 if distilled else 1
    jcfg = jax_vision_cfg("deit" if distilled else "vit", None, **TINY)
    px = np.random.RandomState(6).randn(2, 32, 32, 3).astype(np.float32)
    jm = JE.ViTEncoder(jcfg, patch=16, image_size=32, num_prefix_tokens=prefix)
    jout = jax.jit(jm.apply)({"params": JH.import_vit_tower(dict(state), LAYERS, distilled)},
                             j(px))
    tm = TE.ViTEncoder(torch_cfg(jcfg), patch=16, image_size=32,
                       num_prefix_tokens=prefix).eval()
    keys = TH.merge_into(tm, TH.import_vit_tower(dict(state), LAYERS, distilled))
    assert len(keys) == len(tm.state_dict())
    with torch.no_grad():
        tout = tm(t(px))
    for a, b in zip(tout, jout):
        close(a, b, "float32")


def _reference_mm_late_state(fusion, seed=8):
    state = {}
    for key, v in bert_state(seed, "").items():
        state["dual_encoder.text_model." + key] = v
    for key, v in vit_state(seed + 1).items():
        state["dual_encoder.vision_model." + key] = v
    s = _State(seed + 2)
    s.dense("dual_encoder.text_projection", 512, HID, bias=False)
    s.dense("dual_encoder.visual_projection", 512, HID, bias=False)
    s["dual_encoder.logit_scale"] = np.float32(2.0)
    heads = {"attention": [("fc_Q", HID, HID), ("fc_K", HID, HID), ("fc_V", HID, HID),
                           ("linear_fusion", HID, 2 * HID)],
             "concat": [("linear_fusion", HID, 2 * HID)],
             "aspect-att": [("aspectattention", 1, HID)],
             "gmu": [("linear_gmu_t", 2 * HID, HID), ("linear_gmu_v", 2 * HID, HID),
                     ("linear_fusion", HID, 2 * HID)]}[fusion]
    for name, out, inp in heads + [("linear_cls", LABELS, HID), ("linear_tim", 2, HID),
                                   ("linear_iadds", 2, HID)]:
        s.dense(name, out, inp)
    state.update(s)
    return state


@pytest.mark.parametrize("fusion", ["attention", "concat", "aspect-att", "gmu"])
def test_reference_mm_late_import_matches_jax(fusion, tmp_path):
    state = _reference_mm_late_state(fusion)
    path = str(tmp_path / "mm_model.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)
    jtext = jax_text_cfg("bernice", None, vocab_size=VOCAB, **TINY)
    jvis = jax_vision_cfg("vit", None, **TINY)
    kw = dict(fusion_name=fusion, patch=16, image_size=32)
    jm = JF.MMLateModel(jtext, jvis, LABELS, **kw)
    tm = TF.MMLateModel(torch_cfg(jtext), torch_cfg(jvis), LABELS, **kw).eval()
    rng = np.random.RandomState(9)
    ids, mask = text_batch(rng, vocab=VOCAB, pad_id=1)
    px = rng.randn(3, 32, 32, 3).astype(np.float32)
    tree = JH.import_reference_mm_late(JH.load_torch_file(path), LAYERS, LAYERS, fusion)
    jout = jax.jit(lambda p, *a: jm.apply(p, *a, iadds_task=True))(
        {"params": tree}, j(ids, jnp.int32), j(mask, jnp.int32), j(px))
    keys = TH.merge_into(tm, TH.import_reference_mm_late(TH.load_torch_file(path), LAYERS,
                                                         LAYERS, fusion))
    assert len(keys) == len(tm.state_dict())
    with torch.no_grad():
        tout = tm(t(ids).long(), t(mask), t(px), iadds_task=True)
    for key in ("out_cls", "logits_per_text", "mm_features", "out_iadds"):
        close(tout[key], jout[key], "float32")


def _vilt_heads(seed, hidden):
    """The classifier's own tensors (flax layout) and their reference names."""
    s = _State(seed)
    s.dense("linear", LABELS, hidden)
    s.dense("linear_tim", 2, hidden)
    s.dense("text_projection", 8, hidden)  # declared by the reference, unused: skipped
    s["logit_scale"] = np.float32(1.5)
    return s


@pytest.mark.parametrize("kind", ["hf_backbone", "reference"])
def test_vilt_import_matches_jax(kind):
    """An HF ViltModel checkpoint into the backbone (the builder's import),
    or a reference ``ViLT`` state dict into the whole classifier
    (``--import_reference_ckpt``), at a 64-px square (2 x 2 patches)."""
    from test_torch_vilt import _cfg

    kw = dict(patch=32, image_size=64, dropout=0.0)
    jm = JV.ViltClassifier(_cfg(), LABELS, **kw)
    tm = TV.ViltClassifier(dataclasses.replace(torch_cfg(_cfg()), attn_impl="auto"),
                           LABELS, **kw).eval()
    cfg = jm.cfg
    heads = _vilt_heads(21, cfg.hidden)
    if kind == "reference":
        state = {f"model.{k}": v for k, v in vilt_state(20, "", cfg, side=2).items()}
        state.update(heads)
        tree = JH.import_reference_vilt(dict(state), cfg.layers)
        keys = TH.merge_into(tm, TH.import_reference_vilt(dict(state), cfg.layers))
    else:
        state = vilt_state(20, "vilt.", cfg, side=2)
        head_tree = {"linear": JH._dense(heads, "linear"),
                     "linear_tim": JH._dense(heads, "linear_tim"),
                     "logit_scale": heads["logit_scale"]}
        tree = {"backbone": JH.import_vilt(dict(state), cfg.layers), **head_tree}
        keys = TH.merge_into(tm, TH.import_vilt(dict(state), cfg.layers), "backbone.")
        assert len(keys) == len(tm.backbone.state_dict())
        keys += TH.merge_into(tm, head_tree)
    assert len(keys) == len(tm.state_dict())
    rng = np.random.RandomState(22)
    ids, mask = text_batch(rng, b=3, length=cfg.max_positions, vocab=cfg.vocab_size)
    batch = {"ids": ids, "mask": mask, "token_type_ids": np.zeros_like(ids),
             "pixel_values": rng.randn(3, 64, 64, 3).astype(np.float32)}
    jout = jax.jit(lambda p, *a: jm.apply(p, *a, deterministic=True))(
        {"params": tree}, *(jnp.asarray(batch[k]) for k in
                            ("ids", "mask", "token_type_ids", "pixel_values")))
    with torch.no_grad():
        tout = vilt_port_forward(tm, {k: t(v) for k, v in batch.items()})
    for key in ("out_cls", "logits_per_text"):
        close(tout[key], jout[key], "float32")


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g),
               "f16": torch.randn(4, generator=g).half(),
               "bf16": torch.randn(2, 3, 2, generator=g).bfloat16(),
               "i64": torch.arange(7).reshape(1, 7), "scalar": torch.tensor(2.5)}
    path = str(tmp_path / "model.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = TH.read_safetensors(path)
    assert set(got) == set(tensors)
    for name, want in tensors.items():
        want = want.float() if want.dtype == torch.bfloat16 else want
        assert got[name].shape == tuple(want.shape), name
        np.testing.assert_array_equal(got[name], want.numpy(), err_msg=name)
    # the directory loaders of both packages agree on a ViT checkpoint
    state = vit_state(13)
    save_file({k: torch.from_numpy(v) for k, v in state.items()}, path)
    mine, theirs = TH.load_state_dict(str(tmp_path)), JH.load_state_dict(str(tmp_path))
    assert set(mine) == set(theirs) == set(state)
    for k in state:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_msgpack_only_directory_is_refused(tmp_path):
    """A msgpack-only directory is read now (``test_torch_flax_msgpack.py``
    holds it against the JAX importer); one whose file is no whole msgpack
    document is refused."""
    (tmp_path / "flax_model.msgpack").write_bytes(b"\x81\xa1w")
    with pytest.raises(ValueError, match="msgpack"):
        TH.load_state_dict(str(tmp_path))
    assert TH.load_state_dict(str(tmp_path / "absent")) is None


def test_merge_refuses_unknown_names_and_shapes():
    tm = TE.ViTEncoder(torch_cfg(jax_vision_cfg("vit", None, **TINY)), patch=16, image_size=32)
    before = tm.ln_final.weight.detach().clone()
    tree = TH.import_vit_tower(dict(vit_state(14)), LAYERS)
    tree["ln_final"]["scale"] = tree["ln_final"]["scale"][:-1]
    with pytest.raises(ValueError, match="shape mismatch at ln_final.weight"):
        TH.merge_into(tm, tree)
    tree = TH.import_vit_tower(dict(vit_state(14)), LAYERS)
    tree["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unknown parameter extra.weight"):
        TH.merge_into(tm, tree)
    assert torch.equal(tm.ln_final.weight, before)  # nothing copied


def _late_args(extra=()):
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late

    return run_mm_late.parse_args(["--txt_model_name", "bernice", "--img_model_name", "vit",
                                   "--fusion_name", "attention", "--task", "3",
                                   "--arch", "tiny", "--dtype", "float32",
                                   "--device", "cpu", *extra])


def test_builder_imports_the_vit_checkpoint_directory(tmp_path, monkeypatch):
    """The fault this import repairs: with ``MODEL_DIR_DICT["vit"]`` at a
    directory that holds a checkpoint, the late-fusion model's vision tower
    is the file's, not a random (and frozen) one."""
    from safetensors.torch import save_file

    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C

    vit_dir = tmp_path / "vit"
    vit_dir.mkdir()
    (vit_dir / "config.json").write_text(json.dumps({"image_size": 32, "patch_size": 16}))
    state = vit_state(15)
    save_file({k: torch.from_numpy(v) for k, v in state.items()},
              str(vit_dir / "model.safetensors"))
    monkeypatch.setitem(C.MODEL_DIR_DICT, "vit", str(vit_dir) + os.sep)
    monkeypatch.setitem(C.MODEL_DIR_DICT, "bernice", str(tmp_path / "no_bernice") + os.sep)
    args = _late_args()
    setup = _build.build_mm_late_setup(args, C.serving_config(args),
                                       generator=torch.Generator().manual_seed(0))
    vision = setup.model.dual.vision
    np.testing.assert_array_equal(vision.embeddings.proj.weight.detach().numpy(),
                                  state["embeddings.patch_embeddings.projection.weight"])
    for i in range(LAYERS):
        for name in ("query", "key", "value"):
            np.testing.assert_array_equal(
                getattr(vision.encoder.layers[i].attention, name).weight.detach().numpy(),
                state[f"encoder.layer.{i}.attention.attention.{name}.weight"])
    np.testing.assert_array_equal(vision.pooler.dense.bias.detach().numpy(),
                                  state["pooler.dense.bias"])


def test_import_reference_checkpoint_loads_the_whole_model(tmp_path, monkeypatch):
    """``--import_reference_ckpt``: the late-fusion model built by the
    runner's builder, then the reference state dict, gives the logits of a
    model loaded from the converted state dict."""
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import _build
    from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as C

    for name in ("bernice", "vit"):
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps({"vocab_size": VOCAB, "image_size": 32,
                                                   "patch_size": 16}))
        monkeypatch.setitem(C.MODEL_DIR_DICT, name, str(d) + os.sep)
    state = _reference_mm_late_state("attention", seed=16)
    path = str(tmp_path / "mm_model.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)
    args = _late_args(["--import_reference_ckpt", path])
    setup = _build.build_mm_late_setup(args, C.serving_config(args),
                                       generator=torch.Generator().manual_seed(0))
    _build.import_reference_checkpoint(setup.model, args)
    want = TF.MMLateModel(setup.model.text_cfg, setup.model.vision_cfg, LABELS,
                          fusion_name="attention", patch=16, image_size=32).eval()
    want.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
                          TH.torch_state_from_jax(TH.import_reference_mm_late(
                              TH.load_torch_file(path), LAYERS, LAYERS, "attention")).items()})
    rng = np.random.RandomState(17)
    ids, mask = text_batch(rng, vocab=VOCAB, pad_id=1)
    px = t(rng.randn(3, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        got = setup.model.eval()(t(ids).long(), t(mask), px)["out_cls"]
        ref = want(t(ids).long(), t(mask), px)["out_cls"]
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(SystemExit, match="no such file"):
        _build.import_reference_checkpoint(setup.model, _late_args(
            ["--import_reference_ckpt", str(tmp_path / "absent.pth")]))
