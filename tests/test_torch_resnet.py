"""The PyTorch port's ResNet, conv self-attention, attention-CNN classifier
and CNN fusion model (``MMCnnModel``, ``concat_cnn`` and ``xatt``) against
the JAX package's, on the CPU at a small size (one bottleneck in each of
the first two stages, ``stage_sizes=(1, 1)``, 32-px images; a two-layer
width-64 text tower), with the JAX variables (``params`` and ``batch_stats``) carried
across by ``models/from_jax.py``; the torchvision importer against the JAX
importer; the ``batch_stats`` round trip; and a JAX-written ResNet artifact
read by ``train/checkpoint.py::load_params``.

Tolerances: float32 logits 1e-5 absolute (1e-4 after a train-mode step,
whose BatchNorm divides by batch statistics of 2 images), the running mean
and variance after one train-mode step within 1e-6 absolute plus 1e-6
relative of flax's mutable ``batch_stats`` (the batch variance is
E[x^2] - E[x]^2 in float32 on both sides, summed in another order),
gradients 1e-4 relative to each gradient's largest entry;
bfloat16 convolutions the whole-model ``BF16_TOL`` of
``test_torch_from_jax``. Two stages, not four: past the third stage, with
two images a batch, the JAX module's own float32 gradients on the CPU move
away from its float64 evaluation by more than this tolerance, while the
port's float32 gradients stay near it; at two stages both sides agree
within it."""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socialmedia_textimage_classification_auxlosses_tpu.models import fusion as JF
from socialmedia_textimage_classification_auxlosses_tpu.models import hf_import as JH
from socialmedia_textimage_classification_auxlosses_tpu.models import resnet as JR
from socialmedia_textimage_classification_auxlosses_tpu.models.text import (
    text_encoder_config as jax_text_cfg,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import fusion as TF
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import hf_import as TH
from socialmedia_textimage_classification_auxlosses_tpu_torch.models import resnet as TR
from socialmedia_textimage_classification_auxlosses_tpu_torch.models.from_jax import (
    jax_tree_from_torch,
    load_jax_params,
    torch_state_from_jax,
)
from socialmedia_textimage_classification_auxlosses_tpu_torch.train.checkpoint import (
    load_params,
)

from test_torch_from_jax import TINY, close, j, t, text_batch, to_numpy_tree, torch_cfg

LABELS = 3
SIZES = (1, 1)
PX = 32


def _random_variables(module, *args, seed=0, **kw):
    """Variables of ``module`` for ``args`` without compiling its init: the
    shapes from ``jax.eval_shape``, kernels and embeddings normal with std
    1/sqrt(fan in), the rest as ``_perturb`` draws them."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw), jax.random.PRNGKey(0))

    def draw(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("kernel", "embedding"):
            fan_in = int(np.prod(sd.shape[:-1])) if name == "kernel" else sd.shape[-1]
            return jnp.asarray(rng.randn(*sd.shape).astype(np.float32) / np.sqrt(fan_in))
        return jnp.zeros(sd.shape, sd.dtype)

    return _perturb(jax.tree_util.tree_map_with_path(draw, shapes), seed + 6)


def _perturb(variables, seed=6):
    """BatchNorm scales, biases and running statistics and the attention
    gate drawn at random (flax initialises them to constants)."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        if name in ("bias", "mean", "gamma") and len(shape) == 1:
            return jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.3)
        return x

    return jax.tree_util.tree_map_with_path(draw, variables)


def _carry(variables, module):
    return load_jax_params(module.float(), to_numpy_tree(variables))


@pytest.fixture(scope="module")
def resnet_pair():
    jm = JR.ResNet(SIZES, LABELS)
    px = np.random.RandomState(0).randn(2, PX, PX, 3).astype(np.float32)
    return jm, _random_variables(jm, j(px), train=False), px


def test_resnet_eval_logits_match_jax(resnet_pair):
    jm, variables, px = resnet_pair
    tm = _carry(variables, TR.ResNet(SIZES, LABELS))
    with torch.no_grad():
        out = tm(t(px), train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(jm.apply)(variables, j(px))),
                               atol=1e-5)


def test_resnet_train_step_batch_stats_and_gradients_match_jax(resnet_pair):
    """One train-mode forward: the logits, every parameter's gradient and
    the updated running statistics (flax's mutable ``batch_stats``: biased
    variance, momentum 0.9)."""
    jm, variables, px = resnet_pair
    w = np.random.RandomState(1).randn(2, LABELS).astype(np.float32)

    def loss(params):
        logits, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               j(px), train=True, mutable=["batch_stats"])
        return jnp.sum(logits * w), (logits, upd["batch_stats"])

    (_, (jlogits, new_stats)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    tm = _carry(variables, TR.ResNet(SIZES, LABELS))
    logits = tm(t(px), train=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4)
    want = torch_state_from_jax({"params": to_numpy_tree(jgrads),
                                 "batch_stats": to_numpy_tree(new_stats)})
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad((logits * t(w)).sum(), list(named.values()))
    for (k, _), g in zip(named.items(), grads):
        ref = want[k]
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), k
    buffers = dict(tm.named_buffers())
    assert len(buffers) == 2 * 9  # stem + 2 blocks x (3 + down) BatchNorms
    for k, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), want[k], atol=1e-6, rtol=1e-6, err_msg=k)
    # eval after the step: the running statistics, not the batch's
    with torch.no_grad():
        out = tm(t(px), train=False)
    updated = {"params": variables["params"], "batch_stats": new_stats}
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(jm.apply)(updated, j(px))),
                               atol=1e-5)


def test_resnet_bfloat16_convolutions_match_jax(resnet_pair):
    _, variables, px = resnet_pair
    jm = JR.ResNet(SIZES, LABELS, dtype="bfloat16")
    tm = _carry(variables, TR.ResNet(SIZES, LABELS, dtype="bfloat16"))
    with torch.no_grad():
        close(tm(t(px), train=False), jax.jit(jm.apply)(variables, j(px)), "bfloat16")


def test_conv_attention_classifier_matches_jax(rng):
    jm = JR.ResNetAttnClassifier(SIZES, LABELS)
    px = rng.randn(2, PX, PX, 3).astype(np.float32)
    variables = _random_variables(jm, j(px), train=False, seed=2)
    tm = _carry(variables, TR.ResNetAttnClassifier(SIZES, LABELS))
    with torch.no_grad():
        np.testing.assert_allclose(tm(t(px)).numpy(),
                                   np.asarray(jax.jit(jm.apply)(variables, j(px))), atol=1e-5)
    # the attention alone, and its map
    fmap = rng.randn(2, 2, 2, 64).astype(np.float32)  # eager: a handful of ops
    ja = JR.ConvSelfAttention(64)
    av = _perturb(ja.init(jax.random.PRNGKey(3), j(fmap)))
    ta = _carry(av, TR.ConvSelfAttention(64))
    jout, jattn = ja.apply(av, j(fmap))
    with torch.no_grad():
        tout, tattn = ta(t(fmap).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tout.permute(0, 2, 3, 1).numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(tattn.numpy(), np.asarray(jattn), atol=1e-6)


@pytest.mark.parametrize("fusion", ["concat_cnn", "xatt"])
def test_mm_cnn_model_matches_jax(rng, fusion, monkeypatch):
    """``MMCnnModel`` in eval and train mode (BatchNorm statistics trained;
    dropout 0 on both sides) at ResNet-50's depth cut to one block a stage."""
    monkeypatch.setitem(JR.STAGE_SIZES, "resnet50", SIZES)
    monkeypatch.setitem(TR.STAGE_SIZES, "resnet50", SIZES)
    text_cfg = jax_text_cfg("bernice", None, vocab_size=1000, dropout=0.0, **TINY)
    jm = JF.MMCnnModel(text_cfg, "resnet50", LABELS, fusion_name=fusion, dropout=0.0)
    tm = TF.MMCnnModel(torch_cfg(text_cfg), "resnet50", LABELS, fusion_name=fusion, dropout=0.0)
    ids, mask = text_batch(rng, b=2, vocab=1000)
    px = rng.randn(2, PX, PX, 3).astype(np.float32)
    args = (j(ids, "int32"), j(mask, "int32"), j(px))
    variables = _random_variables(jm, *args, seed=4)
    _carry(variables, tm)
    jout = jax.jit(jm.apply)(variables, *args)
    with torch.no_grad():
        tout = tm(t(ids).long(), t(mask), t(px))
    for key in ("out_cls", "text_pooled", "mm_features"):
        close(tout[key], jout[key], "float32", atol=1e-5)
    jtrain, upd = jax.jit(lambda v, *a: jm.apply(v, *a, deterministic=False, train=True,
                                                 mutable=["batch_stats"]))(variables, *args)
    tm.train()
    ttrain = tm(t(ids).long(), t(mask), t(px), train=True)
    close(ttrain["out_cls"].detach(), jtrain["out_cls"], "float32")
    want = torch_state_from_jax({"params": {}, "batch_stats": to_numpy_tree(upd["batch_stats"])})
    for k, v in want.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v, atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def _torchvision_state(seed=0, sizes=SIZES):
    """A torchvision-layout ResNet state dict (``num_batches_tracked`` and
    the ``fc`` head included) from a seed."""
    rng = np.random.RandomState(seed)
    state = {}

    def conv(name, o, i, k):
        state[f"{name}.weight"] = rng.randn(o, i, k, k).astype(np.float32) * 0.1

    def bn(name, c):
        state[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        state[f"{name}.bias"] = rng.randn(c).astype(np.float32) * 0.1
        state[f"{name}.running_mean"] = rng.randn(c).astype(np.float32) * 0.1
        state[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        state[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, blocks in enumerate(sizes):
        f = 64 * 2 ** s
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            conv(f"{p}.conv1", f, cin, 1)
            bn(f"{p}.bn1", f)
            conv(f"{p}.conv2", f, f, 3)
            bn(f"{p}.bn2", f)
            conv(f"{p}.conv3", 4 * f, f, 1)
            bn(f"{p}.bn3", 4 * f)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * f, cin, 1)
                bn(f"{p}.downsample.1", 4 * f)
            cin = 4 * f
    state["fc.weight"] = rng.randn(1000, cin).astype(np.float32)
    state["fc.bias"] = np.zeros(1000, np.float32)
    return state


@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_resnet_importer_matches_jax(tmp_path, monkeypatch, suffix):
    monkeypatch.setitem(JR.STAGE_SIZES, "resnet50", SIZES)
    monkeypatch.setitem(TR.STAGE_SIZES, "resnet50", SIZES)
    state = _torchvision_state()
    path = str(tmp_path / f"resnet50{suffix}")
    if suffix == ".npz":
        np.savez(path, **state)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    jm = JR.ResNet(SIZES, LABELS)
    px = j(np.zeros((1, PX, PX, 3), np.float32))
    jvars = JH.maybe_import_resnet(_random_variables(jm, px, train=False), path, "resnet50")
    tm = TR.ResNet(SIZES, LABELS)
    fc = tm.fc.weight.detach().clone()
    keys = TH.maybe_import_resnet(tm, path, "resnet50")
    assert "fc.weight" not in keys and torch.equal(tm.fc.weight, fc)  # the head stays new
    want = torch_state_from_jax(to_numpy_tree(jvars))
    own = tm.state_dict()
    for k in keys:
        np.testing.assert_array_equal(own[k].numpy(), want[k], err_msg=k)
    assert len(keys) == len(own) - 2  # everything but fc
    assert TH.maybe_import_resnet(tm, str(tmp_path / "absent.npz"), "resnet50") == []


def test_batch_stats_round_trip_and_jax_artifact(tmp_path, resnet_pair):
    """``{"params", "batch_stats"}`` through ``jax_tree_from_torch`` back to
    the same tree, and a JAX-written ResNet ``net.pth`` (flax msgpack of both
    collections) loaded strictly by ``load_params``."""
    jm, variables, px = resnet_pair
    tm = _carry(variables, TR.ResNet(SIZES, LABELS))
    back = jax_tree_from_torch(tm)
    assert set(back) == {"params", "batch_stats"}
    ref = to_numpy_tree(variables)
    flat_back = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda v: v.numpy(), back))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_back) == len(flat_ref)
    for path, v in flat_back:
        np.testing.assert_array_equal(v, flat_ref[path])
    path = tmp_path / "resnet50_task3_seed30_net.pth"
    path.write_bytes(flax.serialization.to_bytes(variables))
    fresh = load_params(str(path), TR.ResNet(SIZES, LABELS))
    with torch.no_grad():
        np.testing.assert_allclose(fresh(t(px)).numpy(),
                                   np.asarray(jax.jit(jm.apply)(variables, j(px))), atol=1e-5)
    with pytest.raises(RuntimeError):  # a tree without its batch_stats does not load
        path.write_bytes(flax.serialization.to_bytes({"params": variables["params"]}))
        load_params(str(path), TR.ResNet(SIZES, LABELS))
