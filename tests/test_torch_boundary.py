"""The PyTorch port stands alone: every module imports with ``jax`` and
``flax`` blocked (and with ``pandas``, ``msgpack`` and ``PIL`` blocked too:
the card's machine has none of them; the trainers read their data with
``csv`` and the pixel cache, JAX artifacts are read by the port's own msgpack
codec), no source imports the JAX package, pandas or msgpack, the tokenizer
layouts the JAX package reads through the Rust ``tokenizers`` package are read
with ``tokenizers`` and ``regex`` blocked, and asking for CUDA on a host
without it raises instead of falling back to the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import socialmedia_textimage_classification_auxlosses_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(port.__file__)
# the port's name starts with the JAX package's name: match only the latter
JAX_PACKAGE = re.compile(r"socialmedia_textimage_classification_auxlosses_tpu(?!_torch)")
JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|flax|jaxlib|optax|orbax)\b", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG_DIR], port.__name__ + "."))


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _import_all_blocking(blocked, then=""):
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            + then +
            "bad = [m for m in sys.modules if m.startswith("
            "'socialmedia_textimage_classification_auxlosses_tpu.') or "
            "m == 'socialmedia_textimage_classification_auxlosses_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


def test_every_module_imports_without_jax():
    _import_all_blocking(("jax", "flax", "jaxlib"))
    assert len(_modules()) >= 20


def test_every_module_imports_without_pandas_or_pil():
    _import_all_blocking(("jax", "flax", "jaxlib", "pandas", "PIL"))


def test_tokenizer_layouts_read_without_tokenizers_or_regex(tmp_path):
    """The card's machine has neither ``tokenizers``, ``regex`` nor
    ``sentencepiece``: with them blocked (and JAX), ``build_tokenizer`` reads
    a BERT ``vocab.txt``, RoBERTa's ``vocab.json`` + ``merges.txt``, a
    ``tokenizer.json``, an XLM-R-family directory (its ``tokenizer.json``:
    Precompiled, Metaspace, Unigram) and a ``vocab.txt`` without ``[CLS]`` /
    ``[SEP]`` (the C++ WordPiece), with the ids of the JAX package's paths."""
    import json
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_hf_components as HC

    for name in ("bert", "roberta", "tokjson", "wp"):
        (tmp_path / name).mkdir()
    (tmp_path / "bert" / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\nhello\n##s\n")
    byte_level = {"<s>": 0, "<pad>": 1, "</s>": 2, "h": 3, "i": 4, "hi": 5, "\u0120": 6}
    (tmp_path / "roberta" / "vocab.json").write_text(json.dumps(byte_level))
    (tmp_path / "roberta" / "merges.txt").write_text("#version: 0.2\nh i\n")
    (tmp_path / "tokjson" / "tokenizer.json").write_text(json.dumps({
        "normalizer": {"type": "BertNormalizer"}, "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": None, "added_tokens": [],
        "model": {"type": "WordPiece", "vocab": {"[UNK]": 0, "[CLS]": 1, "[SEP]": 2, "hi": 3}}}))
    HC.write_xlmr_dir(tmp_path / "xlmr", HC.xlmr_pieces(["hi", "hello"], 1),
                      HC.build_charsmap({"\uff28": "H", "\u200b": ""}))
    (tmp_path / "wp" / "vocab.txt").write_text("[UNK]\n[PAD]\nhello\n##s\nhi\n")
    then = ("from socialmedia_textimage_classification_auxlosses_tpu_torch.data.tokenizers "
            "import build_tokenizer\n"
            f"root = {str(tmp_path)!r}\n"
            "got = [build_tokenizer(m, root + '/' + d, 8, 100, normalize=False)(['hi hellos'])"
            "['ids'][0].tolist() for m, d in (('bert', 'bert'), ('roberta', 'roberta'), "
            "('bert', 'tokjson'), ('bernice', 'xlmr'), ('bert', 'wp'))]\n"
            "got.append(build_tokenizer('bernice', root + '/xlmr', 8, 100, normalize=False)("
            "['\\uff28i\\u200b  hello'])['ids'][0].tolist())\n"
            "assert got == [[2, 1, 4, 5, 3, 0, 0, 0], [0, 5, 6, 3, 2, 1, 1, 1], "
            "[1, 3, 0, 2, 0, 0, 0, 0], [0, 10, 7, 14, 3, 2, 1, 1], [101, 4, 2, 3, 102, 1, 1, 1], "
            "[0, 4, 3, 7, 14, 2, 1, 1]], got\n")
    _import_all_blocking(("jax", "flax", "jaxlib", "tokenizers", "regex", "transformers",
                          "sentencepiece"), then)


def test_every_module_imports_without_msgpack_or_pandas():
    """The JAX artifacts are read by the port's own msgpack codec and the
    grid's tables written with ``csv``: the card's machine has neither
    msgpack nor pandas."""
    mods = _modules()
    for name in ("train.flax_msgpack", "train.ensemble", "cli.run_seed_sweep", "cli.run_grid"):
        assert f"{port.__name__}.{name}" in mods, name
    _import_all_blocking(("jax", "flax", "jaxlib", "msgpack", "pandas"))


def test_early_fusion_modules_import_without_jax():
    """LXMERT, MMBT, the ROI cache, the grid features, the detector and the
    demo: in the walk, and imported with JAX, flax, pandas and PIL blocked."""
    mods = _modules()
    for name in ("models.lxmert", "models.mmbt", "cli.obj_features", "cli._build_early",
                 "data.cache", "models.frcnn", "cli.demo_lxmert"):
        assert f"{port.__name__}.{name}" in mods, name
    _import_all_blocking(("jax", "flax", "jaxlib", "pandas", "PIL"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert not JAX_IMPORT.search(text), path
    imports = [line for line in text.splitlines()
               if re.match(r"\s*(import|from)\s", line) and JAX_PACKAGE.search(line)]
    assert not imports, imports
    assert not re.search(r"^\s*(import|from)\s+(pandas|msgpack)\b", text, re.M), path


def test_asking_for_cuda_without_it_raises(monkeypatch):
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_args(["--task", "3", "--arch", "tiny", "--random_init"])
    assert args.device == "cuda"  # the default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_service(args)


def test_kernel_wrappers_refuse_cpu_tensors():
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention, attn_block

    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        attention.sdpa_fwd_cuda(x, x, x, None, 1.0)
    h = torch.zeros(1, 4, 8)
    w, b = torch.zeros(8, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block.attn_block_cuda(h, None, w, b, w, b, w, b, w, b, 2, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block.attn_block_perhead_cuda(h, None, w, b, w, b, w, b, w, b, 2, 1.0)


def test_trainer_asks_for_cuda_by_default(monkeypatch):
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_late

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = run_mm_late.parse_args(["--task", "3", "--txt_model_name", "bernice",
                                   "--img_model_name", "vit", "--fusion_name", "attention"])
    assert args.device == "cuda"  # the default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_mm_late.main(["--task", "3", "--txt_model_name", "bernice",
                          "--img_model_name", "vit", "--fusion_name", "attention"])


def test_backward_wrappers_refuse_cpu_tensors():
    from socialmedia_textimage_classification_auxlosses_tpu_torch.ops import attention, attn_block

    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        attention.sdpa_bwd_cuda(x, x, x, None, x, 1.0)
    h = torch.zeros(1, 4, 8)
    w, b = torch.zeros(8, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block.attn_block_bwd_cuda(h, None, w, b, w, b, w, b, w, h, 2, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block.attn_block_perhead_bwd_cuda(h, None, w, b, w, b, w, b, w, h, 2, 1.0)


def test_early_fusion_trainer_asks_for_cuda_by_default(monkeypatch):
    from socialmedia_textimage_classification_auxlosses_tpu_torch.cli import run_mm_early

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--task", "3", "--model", "vilt", "--vilt_exact_resize"]
    assert run_mm_early.parse_args(argv).device == "cuda"  # the default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_mm_early.main(argv)


def test_vilt_path_modules_are_walked():
    mods = _modules()
    for name in ("cli._build_early", "cli.run_mm_early", "models.vilt", "models.hf_import",
                 "data.bpe_backends"):
        assert f"{port.__name__}.{name}" in mods, name


def test_exact_vilt_source_runs_without_pil_from_its_memo():
    """The card's machine has no PIL: a memo filled by the caller is all
    ``ExactViltImageSource.gather`` reads."""
    code = ("import sys\n"
            "sys.modules['PIL'] = None\n"
            "import numpy as np\n"
            "from socialmedia_textimage_classification_auxlosses_tpu_torch.data.pipeline "
            "import ExactViltImageSource\n"
            "src = ExactViltImageSource('/nonexistent/{}.jpg')\n"
            "src.memo['7'] = (np.ones((608, 608, 3), np.uint8), (352, 480))\n"
            "frames, grid = src.gather([7, 7])\n"
            "assert frames.shape == (2, 608, 608, 3) and frames.all()\n"
            "assert grid.tolist() == [[352, 480], [352, 480]]\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"
