"""Importer-on-arrival verification: run every checkpoint importer of the port
with its parity check and print a pass/fail table.

Counterpart of the JAX package's ``cli/verify_imports.py``. The pretrained
weights come from local directories (``MODEL_DIR_DICT``); they are not
bundled, so this command turns "the importers should work" into "shown on
arrival": point the directories at the checkpoints and it imports each one
into the port's modules and compares them with the Hugging Face model loaded
from the same directory.

Two stages (default both):

* ``synthetic``: the port's importer parity tests (``SYNTHETIC_SUITE``,
  every importer of ``models/hf_import.py``, the ResNet and Faster R-CNN
  loaders and the JAX-artifact reader) as one pytest subprocess, one table
  row per entry. These tests hold the port against the JAX package, so this
  stage runs on a host that has JAX (not on the card's machine).
* ``real``: for every family whose ``MODEL_DIR_DICT`` directory holds
  weights (``pytorch_model.bin``, ``model.safetensors`` or
  ``flax_model.msgpack``), import it at the checkpoint's geometry and
  compare the port's outputs with ``transformers``'
  ``AutoModel.from_pretrained`` on random inputs (float32, ``--atol``).
  ``transformers`` is imported only here; where it is missing each such row
  is reported as skipped, not failed. ``--reference_ckpt mm_late=path.pth``
  (or ``vilt=``, ``lxmert=``) imports a reference-trained state dict.

Exit code 0 iff every attempted check passed (skips do not fail).

    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.verify_imports
    python -m socialmedia_textimage_classification_auxlosses_tpu_torch.cli.verify_imports \\
        --stage real
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..core import config as C
from ..utils.logging import get_logger

logger = get_logger(__name__)

# the synthetic stage: the port's importer parity tests, as (label, node id)
SYNTHETIC_SUITE = [
    ("text towers (bert/roberta/bernice) + vit/deit", "tests/test_torch_hf_import.py"),
    ("beit tower (rel-pos/layer-scale)",
     "tests/test_torch_vision.py::test_beit_importer_matches_jax"),
    ("dual encoder + reference-trained mm_late .pth",
     "tests/test_torch_hf_import.py::test_reference_mm_late_import_matches_jax"),
    ("vilt + reference-trained vilt .pth",
     "tests/test_torch_hf_import.py::test_vilt_import_matches_jax"),
    ("lxmert tower", "tests/test_torch_lxmert.py::test_import_lxmert_matches_jax"),
    ("reference-trained lxmert .pth",
     "tests/test_torch_lxmert.py::test_import_reference_lxmert_matches_jax"),
    ("lxmert from a checkpoint directory",
     "tests/test_torch_lxmert.py::test_maybe_import_lxmert_from_a_directory_matches_jax"),
    ("mmbt (bert + resnet)", "tests/test_torch_mmbt.py::test_maybe_import_mmbt_matches_jax"),
    ("resnet mapping (torchvision)",
     "tests/test_torch_resnet.py::test_resnet_importer_matches_jax"),
    ("frcnn vs torch twin", "tests/test_torch_frcnn.py::test_end_to_end_matches_the_torch_twin"),
    ("JAX-trained artifacts (flax msgpack)", "tests/test_torch_flax_msgpack.py"),
]

TEXT_FAMILIES = ("bert", "bertweet", "roberta", "bernice")
VISION_FAMILIES = ("vit", "beit", "deit")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="verify every checkpoint importer")
    p.add_argument("--stage", choices=["synthetic", "real", "both"], default="both")
    p.add_argument("--families", type=str, default=None,
                   help="comma list to restrict the real stage "
                        "(default: every family with weights present)")
    p.add_argument("--reference_ckpt", action="append", default=[], metavar="FAMILY=PATH",
                   help="reference-trained .pth to import-verify "
                        "(mm_late=..., vilt=..., lxmert=...)")
    p.add_argument("--atol", type=float, default=1e-3,
                   help="absolute tolerance for full-geometry real checks "
                        "(float32; 12-layer accumulation)")
    p.add_argument("--seq", type=int, default=16, help="random text length for real checks")
    return p.parse_args(argv)


def _has_weights(model_dir):
    if not model_dir or not os.path.isdir(model_dir):
        return False
    return any(os.path.isfile(os.path.join(model_dir, f))
               for f in ("pytorch_model.bin", "model.safetensors", "flax_model.msgpack"))


def _max_err(ours, theirs) -> float:
    return float((ours.detach().float() - theirs.detach().float()).abs().max())


# --------------------------------------------------------------------------
# real stage checks (checkpoint geometry vs transformers.from_pretrained)
# --------------------------------------------------------------------------


def check_text_tower(name, model_dir, atol, seq):
    from transformers import AutoModel

    from ..models import hf_import as H
    from ..models.encoder import BertEncoder
    from ..models.text import text_encoder_config

    hf = AutoModel.from_pretrained(model_dir).eval()
    cfg = text_encoder_config(name, model_dir, dtype="float32", attn_impl="jnp")
    model = BertEncoder(cfg).eval()
    H.maybe_import_text_tower(model, model_dir, cfg.layers, prefix="")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(cfg.pos_offset + 1, cfg.vocab_size, (2, seq)))
    mask = torch.ones((2, seq), dtype=torch.int64)
    tt = torch.zeros((2, seq), dtype=torch.int64)
    with torch.no_grad():
        hidden, _ = model(ids, mask, tt if cfg.type_vocab > 1 else None)
        out = hf(ids, attention_mask=mask, token_type_ids=tt if cfg.type_vocab > 1 else None)
    err = _max_err(hidden, out.last_hidden_state)
    assert err <= atol, f"last_hidden max err {err}"
    return err


def check_vision_tower(name, model_dir, atol):
    from transformers import AutoModel

    from ..models import hf_import as H
    from ..models.encoder import ViTEncoder
    from ..models.vision import vision_encoder_config, vit_geometry

    hf = AutoModel.from_pretrained(model_dir, add_pooling_layer=False).eval()
    cfg = vision_encoder_config(name, model_dir, dtype="float32", attn_impl="jnp")
    geo = vit_geometry(name, model_dir)
    rng = np.random.RandomState(0)
    px = torch.from_numpy(rng.randn(2, geo["image_size"], geo["image_size"], 3)
                          .astype(np.float32))
    if name == "beit":
        from ..models.beit import BeitEncoder

        model = BeitEncoder(cfg, patch=geo["patch"], image_size=geo["image_size"]).eval()
        H.maybe_import_beit_tower(model, model_dir, cfg.layers, prefix="")
    else:
        model = ViTEncoder(cfg, patch=geo["patch"], image_size=geo["image_size"],
                           num_prefix_tokens=geo["num_prefix_tokens"]).eval()
        H.maybe_import_vision_tower(model, model_dir, cfg.layers, distilled=name == "deit",
                                    prefix="")
    with torch.no_grad():
        hidden = model(px)[0]
        out = hf(px.permute(0, 3, 1, 2))
    err = _max_err(hidden, out.last_hidden_state)
    assert err <= atol, f"last_hidden max err {err}"
    return err


def check_vilt(model_dir, atol, seq):
    from transformers import ViltModel

    from ..models import hf_import as H
    from ..models.encoder import EncoderConfig
    from ..models.text import _load_hf_config
    from ..models.vilt import ViltBackbone

    hf_cfg = _load_hf_config(model_dir)
    hf = ViltModel.from_pretrained(model_dir).eval()
    cfg = EncoderConfig(
        vocab_size=hf_cfg.get("vocab_size", 30522), hidden=hf_cfg.get("hidden_size", 768),
        layers=hf_cfg.get("num_hidden_layers", 12), heads=hf_cfg.get("num_attention_heads", 12),
        mlp_dim=hf_cfg.get("intermediate_size", 3072),
        max_positions=hf_cfg.get("max_position_embeddings", 40), type_vocab=2,
        ln_style="pre", dropout=0.0, dtype="float32", attn_impl="jnp")
    size = hf_cfg.get("image_size", 384)
    model = ViltBackbone(cfg, patch=hf_cfg.get("patch_size", 32), image_size=size).eval()
    H.maybe_import_vilt(model, model_dir, cfg.layers, prefix="")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, cfg.vocab_size, (2, min(seq, cfg.max_positions))))
    mask, tt = torch.ones_like(ids), torch.zeros_like(ids)
    px = torch.from_numpy(rng.randn(2, size, size, 3).astype(np.float32))
    with torch.no_grad():
        hidden, pooled = model(ids, mask, tt, px)
        out = hf(input_ids=ids, attention_mask=mask, token_type_ids=tt,
                 pixel_values=px.permute(0, 3, 1, 2))
    theirs = out.last_hidden_state
    # HF ViLT's visual embedding permutes the patch tokens (multinomial
    # sampling); the stack is permutation-equivariant over (patch, position)
    # pairs, so the text tokens, the image CLS and the pooled output match by
    # position and the patch tokens as a set (compared through their sum)
    n = ids.shape[1]
    err = max(_max_err(hidden[:, :n + 1], theirs[:, :n + 1]),
              _max_err(hidden[:, n + 1:].sum(1), theirs[:, n + 1:].sum(1)),
              _max_err(pooled, out.pooler_output))
    assert err <= atol, f"joint hidden/pooled max err {err}"
    return err


def check_lxmert(model_dir, atol, seq):
    from transformers import LxmertModel

    from ..models import hf_import as H
    from ..models.lxmert import LxmertBackbone, LxmertConfig
    from ..models.text import _load_hf_config

    hf_cfg = _load_hf_config(model_dir)
    hf = LxmertModel.from_pretrained(model_dir).eval()
    cfg = LxmertConfig(
        vocab_size=hf_cfg.get("vocab_size", 30522), hidden=hf_cfg.get("hidden_size", 768),
        heads=hf_cfg.get("num_attention_heads", 12),
        mlp_dim=hf_cfg.get("intermediate_size", 3072), l_layers=hf_cfg.get("l_layers", 9),
        r_layers=hf_cfg.get("r_layers", 5), x_layers=hf_cfg.get("x_layers", 5),
        visual_feat_dim=hf_cfg.get("visual_feat_dim", 2048), dropout=0.0, attn_impl="jnp")
    model = LxmertBackbone(cfg).eval()
    H.maybe_import_lxmert(model, model_dir, cfg.l_layers, cfg.r_layers, cfg.x_layers, prefix="")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, cfg.vocab_size, (2, seq)))
    mask, tt = torch.ones_like(ids), torch.zeros_like(ids)
    feats = torch.from_numpy(rng.randn(2, 36, cfg.visual_feat_dim).astype(np.float32))
    boxes = torch.from_numpy(rng.rand(2, 36, 4).astype(np.float32))
    with torch.no_grad():
        lang, vis = model(ids, mask, tt, feats, boxes)
        out = hf(input_ids=ids, attention_mask=mask, token_type_ids=tt, visual_feats=feats,
                 visual_pos=boxes)
    err = max(_max_err(lang, out.language_output), _max_err(vis, out.vision_output))
    assert err <= atol, f"language/vision output max err {err}"
    return err


def _layer_count(state, pattern) -> int:
    return 1 + max((int(m.group(1)) for k in state if (m := re.search(pattern, k))), default=-1)


def check_reference_ckpt(family, path, atol):
    """Import a reference-trained wrapper state dict (.pth): the importer
    must finish with every tensor finite. Returns the tensor count."""
    from ..models import hf_import as H
    from ..models.from_jax import torch_state_from_jax

    state = H.load_torch_file(path)
    assert state is not None, f"cannot read {path}"
    if family == "mm_late":
        tree = H.import_reference_mm_late(
            state, _layer_count(state, r"text_model\.encoder\.layer\.(\d+)\."),
            _layer_count(state, r"vision_model\.encoder\.layer\.(\d+)\."), "attention")
    elif family == "vilt":
        tree = H.import_reference_vilt(state, _layer_count(state, r"encoder\.layer\.(\d+)\."))
    elif family == "lxmert":
        tree = H.import_reference_lxmert(
            state, _layer_count(state, r"encoder\.layer\.(\d+)\."),
            _layer_count(state, r"encoder\.r_layers\.(\d+)\."),
            _layer_count(state, r"encoder\.x_layers\.(\d+)\."))
    else:
        raise SystemExit(f"--reference_ckpt family {family!r} not supported")
    leaves = list(torch_state_from_jax(tree).values())
    assert leaves, "importer produced an empty tree"
    assert all(np.isfinite(np.asarray(a)).all() for a in leaves), "non-finite imported weights"
    return float(len(state))


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_synthetic():
    """One pytest subprocess over ``SYNTHETIC_SUITE``; returns the rows. A row
    fails when a failed or erroring test lies under its node id."""
    ids = [t for _, t in SYNTHETIC_SUITE]
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rfE", "--tb=line",
                           "-p", "no:cacheprovider", *ids],
                          cwd=_repo_root(), env=env, capture_output=True, text=True,
                          timeout=7200)
    bad = set(re.findall(r"^(?:FAILED|ERROR) (\S+)", proc.stdout, re.M))
    if proc.returncode != 0 and not bad:
        # collection- or abort-level failure: every row shows it
        logger.error("synthetic suite rc=%d\n%s", proc.returncode, proc.stdout[-2000:])
        return [("synthetic", label, "FAIL (suite aborted)", nodeid)
                for label, nodeid in SYNTHETIC_SUITE]
    return [("synthetic", label,
             "FAIL" if any(b == nodeid or b.startswith(nodeid + "::")
                           or (b.startswith(nodeid + "[")) for b in bad) else "PASS",
             nodeid)
            for label, nodeid in SYNTHETIC_SUITE]


def run_real(args):
    fams = (args.families.split(",") if args.families
            else list(TEXT_FAMILIES) + list(VISION_FAMILIES) + ["vilt", "lxmert"])
    have_transformers = importlib.util.find_spec("transformers") is not None
    rows = []
    for fam in fams:
        model_dir = C.MODEL_DIR_DICT.get(fam)
        if not _has_weights(model_dir):
            rows.append(("real", fam, "SKIP (no weights)", model_dir or "-"))
            continue
        if not have_transformers:
            rows.append(("real", fam, "SKIP (no transformers)", model_dir))
            continue
        try:
            if fam in TEXT_FAMILIES:
                err = check_text_tower(fam, model_dir, args.atol, args.seq)
            elif fam in VISION_FAMILIES:
                err = check_vision_tower(fam, model_dir, args.atol)
            elif fam == "vilt":
                err = check_vilt(model_dir, args.atol, args.seq)
            elif fam == "lxmert":
                err = check_lxmert(model_dir, args.atol, args.seq)
            else:
                rows.append(("real", fam, "SKIP (unknown)", "-"))
                continue
            rows.append(("real", fam, f"PASS (max err {err:.2e})", model_dir))
        except Exception as e:  # report, keep going
            logger.exception("real check %s failed", fam)
            rows.append(("real", fam, f"FAIL ({e})", model_dir))
    for spec in args.reference_ckpt:
        fam, _, path = spec.partition("=")
        try:
            n = check_reference_ckpt(fam, path, args.atol)
            rows.append(("real", f"reference .pth ({fam})", f"PASS ({int(n)} tensors)", path))
        except Exception as e:
            logger.exception("reference ckpt %s failed", spec)
            rows.append(("real", f"reference .pth ({fam})", f"FAIL ({e})", path))
    return rows


def main(argv=None):
    args = parse_args(argv)
    rows = []
    if args.stage in ("synthetic", "both"):
        logger.info("running the port's importer parity suite (needs JAX on this host)...")
        rows += run_synthetic()
    if args.stage in ("real", "both"):
        rows += run_real(args)
    width = max(len(r[1]) for r in rows) if rows else 10
    print(f"\n{'stage':<10} {'check':<{width}}  result")
    print("-" * (14 + width + 30))
    for stage, label, status, _ in rows:
        print(f"{stage:<10} {label:<{width}}  {status}")
    bad = [r for r in rows if r[2].startswith("FAIL")]
    print(f"\n{len(rows) - len(bad)}/{len(rows)} checks ok "
          f"({sum(1 for r in rows if r[2].startswith('SKIP'))} skipped)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
