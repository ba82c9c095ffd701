"""JAX-trained artifacts in the PyTorch port, on the CPU: the port's own
msgpack codec (``train/flax_msgpack.py``) against ``flax.serialization``
(every leaf kind flax writes, chunked arrays, bytes equal both ways), a JAX
``save_params`` artifact of the tiny late-fusion model (unrolled and
``--scan_layers``) read by the port's ``load_params`` with the JAX forward's
outputs (float32, atol 1e-5), ``flax_model.msgpack`` directories read as the
JAX importer reads them, ``models/from_jax.py::jax_tree_from_torch`` as the
inverse of the carry, and ``serve --scan_layers`` on a JAX artifact."""

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models import hf_import as JH
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.models.vision import (
    vision_encoder_config as jax_vision_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu.train import checkpoint as JCk
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve as tserve
from socialmedia_textimage_classification_auxlosses_tpu_torch.cli._build import (
    build_mm_late_setup,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.core import config as TC
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as TH
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    jax_tree_from_torch, torch_state_from_jax,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train import flax_msgpack as M
from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
    load_params, save_params,
)

from test_torch_from_jax import TINY, j, t, text_batch, torch_cfg


def _same(port, ref):
    """A decoded tree equals flax's decoding of the same bytes."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), (port, ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, (np.ndarray, np.generic, jax.Array)):
        ref = np.asarray(ref)
        assert isinstance(port, torch.Tensor) and tuple(port.shape) == ref.shape
        assert str(port.dtype).removeprefix("torch.") == ref.dtype.name
        np.testing.assert_array_equal(port.float().numpy() if port.dtype == torch.bfloat16
                                      else port.numpy(), ref.astype(np.float32)
                                      if ref.dtype.name == "bfloat16" else ref)
    else:
        assert port == ref and type(port) is type(ref), (port, ref)


def _tree(rng):
    return {"params": {
        "dense": {"kernel": rng.randn(3, 5).astype(np.float32),
                  "bias": jnp.asarray(rng.randn(5), jnp.bfloat16)},
        "ids": rng.randint(-9, 9, (2, 3)).astype(np.int32),
        "mask": rng.rand(4) < 0.5, "empty": {}, "zero_rows": np.zeros((0, 4), np.float32),
        "scale": np.float32(2.5), "count": np.int64(7), "wide": rng.randn(40, 70),
        "u8": rng.randint(0, 255, 300).astype(np.uint8)},
        "step": 3, "neg": -100, "big": 2 ** 40, "lr": 1.5e-5, "name": "a" * 40,
        "flag": True, "none": None, "list": [1, 2, 3]}


def test_decoder_reads_what_flax_writes(rng):
    data = fs.to_bytes(_tree(rng))
    port = M.msgpack_restore(data)
    _same(port, fs.msgpack_restore(data))
    assert port["params"]["dense"]["bias"].dtype == torch.bfloat16
    assert port["params"]["scale"].shape == () and float(port["params"]["scale"]) == 2.5
    # a bytearray is shared by the tensors, not copied
    shared = M.msgpack_restore(bytearray(data))
    _same(shared, fs.msgpack_restore(data))


def test_decoder_reads_chunked_arrays(rng, monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 256)
    tree = {"params": {"table": rng.randn(30, 7).astype(np.float32),
                       "half": jnp.asarray(rng.randn(300), jnp.bfloat16)}}
    data = fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _same(M.msgpack_restore(data), fs.msgpack_restore(data))


@pytest.mark.parametrize("chunk", [M.MAX_CHUNK_SIZE, 256], ids=["whole", "chunked"])
def test_encoder_writes_flax_bytes(rng, monkeypatch, chunk):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(M, "MAX_CHUNK_SIZE", chunk)
    tree = {"params": {"k": torch.from_numpy(rng.randn(30, 7).astype(np.float32)),
                       "b": torch.from_numpy(rng.randn(300).astype(np.float32)).bfloat16(),
                       "i": torch.arange(5, dtype=torch.int32), "e": {}},
            "step": 12, "name": "x"}
    data = bytes(M.msgpack_serialize(tree))

    def as_flax(v):  # key order kept, as flax writes it
        if isinstance(v, dict):
            return {k: as_flax(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            return (jnp.asarray(v.float().numpy(), jnp.bfloat16)
                    if v.dtype == torch.bfloat16 else v.numpy())
        return v

    assert data == fs.to_bytes(as_flax(tree))
    _same(M.msgpack_restore(data), fs.msgpack_restore(data))


def test_decoder_refuses_what_is_no_parameter_tree():
    import msgpack

    with pytest.raises(ValueError, match="complex"):
        M.msgpack_restore(fs.to_bytes({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="ext type 9"):
        M.msgpack_restore(msgpack.packb({"x": msgpack.ExtType(9, b"ab")}))
    with pytest.raises(ValueError, match="ends inside"):
        M.msgpack_restore(fs.to_bytes({"w": np.ones(8, np.float32)})[:-3])
    assert M.is_msgpack_tree(fs.to_bytes({"w": 1}))
    assert not M.is_msgpack_tree(b"PK\x03\x04") and not M.is_msgpack_tree(b"\x80\x02")


def _models(scan):
    text_cfg = jax_text_cfg("bernice", None, dtype="float32", attn_impl="jnp",
                            vocab_size=1000, scan_layers=scan, **TINY)
    vis_cfg = jax_vision_cfg("vit", None, dtype="float32", attn_impl="jnp",
                             scan_layers=scan, **TINY)
    kw = dict(fusion_name="attention", patch=16, image_size=32)
    return (JF.MMLateModel(text_cfg, vis_cfg, 3, **kw),
            TF.MMLateModel(torch_cfg(text_cfg), torch_cfg(vis_cfg), 3, **kw))


@pytest.fixture(scope="module")
def jax_late():
    """The tiny JAX late-fusion model's parameters, unrolled and (the same
    values stacked by JAX ``stack_scan_layers``) in the scan layout, and a
    batch."""
    rng = np.random.RandomState(11)
    ids, mask = text_batch(rng, b=3, vocab=1000)
    px = rng.randn(3, 32, 32, 3).astype(np.float32)
    jm = _models(False)[0]
    init = jax.jit(lambda k, i, m, x: JF.init_mm_late_params(jm, k, i, m, x))
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(5), j(ids, "int32"),
                                                     j(mask, "int32"), j(px)))
    dual = params["params"]["dual"]
    scan = {"params": dict(params["params"], dual=dict(
        dual, text=JH.stack_scan_layers(dual["text"], TINY["layers"]),
        vision=JH.stack_scan_layers(dual["vision"], TINY["layers"])))}
    return {False: params, True: scan}, (ids, mask, px)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_layers"])
def test_jax_artifact_loads_with_the_jax_forward(jax_late, tmp_path, scan):
    trees, (ids, mask, px) = jax_late
    jm, tm = _models(scan)
    path = str(tmp_path / "bernice-vit-attention_task3_seed30__net.pth")
    JCk.save_params(path, trees[scan])
    load_params(path, tm)
    tim_src = np.array([2, 0, 1], np.int32)
    apply = jax.jit(lambda p, i, m, x, src: jm.apply(p, i, m, x, iadds_task=True,
                                                     tim_src=src))
    jout = apply(trees[scan], j(ids, "int32"), j(mask, "int32"), j(px), j(tim_src, "int32"))
    with torch.no_grad():
        tout = tm.eval()(t(ids).long(), t(mask), t(px), iadds_task=True,
                         tim_src=t(tim_src).long())
    for key in ("out_cls", "logits_per_text", "out_tim", "out_iadds"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), rtol=0,
                                   atol=1e-5, err_msg=key)


def test_torch_artifacts_still_load_and_the_inverse_carries_back(jax_late, tmp_path):
    trees, _ = jax_late
    tm = _models(False)[1]
    state = torch_state_from_jax(trees[False])
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    for scan in (False, True):
        tree = jax_tree_from_torch(tm, scan_layers=scan)
        mine = {"/".join(k.key for k in path): tuple(v.shape) for path, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        want = {"/".join(k.key for k in path): v.shape for path, v in
                jax.tree_util.tree_flatten_with_path(trees[scan])[0]}
        assert mine == want  # the JAX tree's names, layout and shapes
        back = torch_state_from_jax(tree)
        assert set(back) == set(tm.state_dict())
        for k, v in tm.state_dict().items():
            np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    path = str(tmp_path / "net.pth")
    save_params(path, tm)
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"
    fresh = _models(False)[1]
    load_params(path, fresh)
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_flax_model_msgpack_directory_reads_as_the_jax_importer(rng, tmp_path):
    tree = {"bert": {"embeddings": {"word_embeddings": {
        "embedding": rng.randn(20, 8).astype(np.float32)}},
        "pooler": {"dense": {"kernel": jnp.asarray(rng.randn(8, 8), jnp.bfloat16),
                             "bias": np.zeros(8, np.float32)}}}}
    (tmp_path / "flax_model.msgpack").write_bytes(fs.to_bytes(tree))
    mine, theirs = TH.load_state_dict(str(tmp_path)), JH.load_state_dict(str(tmp_path))
    assert set(mine) == set(theirs) == {"bert.embeddings.word_embeddings.embedding",
                                        "bert.pooler.dense.kernel", "bert.pooler.dense.bias"}
    for k in theirs:
        assert isinstance(mine[k], np.ndarray)
        np.testing.assert_array_equal(mine[k], np.asarray(theirs[k], np.float32), err_msg=k)


def test_serve_takes_a_scan_layout_jax_artifact(tmp_path):
    """``serve --scan_layers`` answers from a scan-layout artifact that the
    JAX package's ``save_params`` wrote, as from the same weights in the
    port's own torch file. The layout is read from the file: the flag, as
    the JAX CLI takes it, changes nothing."""
    base = ["--task", "3", "--txt_model_name", "bernice", "--img_model_name", "vit",
            "--fusion_name", "attention", "--arch", "tiny", "--max_batch", "2",
            "--dtype", "float32", "--device", "cpu"]
    args = tserve.parse_args(base + ["--random_init"])
    model = build_mm_late_setup(args, TC.serving_config(args),
                                generator=torch.Generator().manual_seed(4)).model
    torch_path, jax_path = str(tmp_path / "port.pth"), str(tmp_path / "jax_scan_net.pth")
    save_params(torch_path, model)
    JCk.save_params(jax_path, jax.tree_util.tree_map(
        lambda v: v.numpy(), jax_tree_from_torch(model, scan_layers=True)))
    img = np.random.RandomState(3).randint(0, 256, (224, 224, 3), np.uint8)
    reqs = [("storm coming #weather", img), ("what a day", None)]

    def probs(path, *extra):
        predict, _ = tserve.build_service(tserve.parse_args(base + ["--model_path", path,
                                                                    *extra]))
        return np.array([r["probs"] for r in predict(reqs)])

    want = probs(torch_path)
    np.testing.assert_array_equal(probs(jax_path, "--scan_layers"), want)
    np.testing.assert_array_equal(probs(jax_path), want)
    np.testing.assert_array_equal(probs(torch_path, "--scan_layers"), want)
