"""The port imports torch, never JAX or the JAX package: a fresh process
that imports every port module (and ``chip_smoke.py``) adds no ``jax*``
module and no ``gan_image_captioning_tpu`` / ``gan_image_captioning_tpu.*``
module (the exact name: the port's own name shares the prefix), and a
source scan finds no such import.  Importing builds no kernel."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gan_image_captioning_tpu_torch")


def _port_sources():
    for root, _, names in os.walk(PORT):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(root, n)
    yield os.path.join(REPO, "chip_smoke.py")


def _module_name(path):
    rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _forbidden(name):
    top = name.split(".")[0]
    return (top in ("jax", "jaxlib") or top.startswith("jax_")
            or top == "gan_image_captioning_tpu")


def test_fresh_import_adds_no_jax_module():
    modules = [_module_name(p) for p in _port_sources()]
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from gan_image_captioning_tpu_torch.kernels import build\n"
        "print(json.dumps({'added': sorted(set(sys.modules) - before),\n"
        "                  'libs': len(build._LIBS)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    added = result["added"]
    for name in ("serve", "serving", "ops.quantize", "eval.decode",
                 "kernels.decode_sample", "main", "kernels.image_norm",
                 "models.resnet", "models.encoder", "data.coco",
                 "data.images", "data.loader", "data.synthetic",
                 "data.vocab", "train.instructor", "train.checkpoint",
                 "utils.logging", "kernels.flash_attention",
                 "kernels.gumbel_sample", "models.transformer",
                 "models.discriminator_transformer", "train.reinforce",
                 "evaluate", "caption", "eval.bleu", "eval.cider",
                 "eval.rouge", "eval.meteor", "eval.diversity",
                 "eval.metrics", "train.schedule", "train.scst",
                 "models.vit", "data.bpe", "models.torch_import",
                 "import_gpt2", "import_vit"):
        assert f"gan_image_captioning_tpu_torch.{name}" in added
    assert "torch" in added or "torch" in sys.modules
    assert [m for m in added if _forbidden(m)] == []
    assert not any(m == "triton" or m.startswith("triton.") for m in added)
    # Pillow is imported where an image is decoded, never at import
    assert not any(m == "PIL" or m.startswith("PIL.") for m in added)
    assert result["libs"] == 0


def test_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert bad == []


def test_forbidden_matches_exact_package_name():
    assert _forbidden("gan_image_captioning_tpu")
    assert _forbidden("gan_image_captioning_tpu.models.lstm")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("gan_image_captioning_tpu_torch.models.lstm")


def _imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def test_bpe_needs_only_the_standard_library():
    """The port's BPE pre-tokenizer scans with ``unicodedata``: no
    ``regex`` (the card's machine has none), nothing of JAX, and in a
    fresh process importing it and encoding loads neither."""
    names = _imports_of(os.path.join(PORT, "data", "bpe.py"))
    assert not [n for n in names if n.split(".")[0] == "regex"
                or _forbidden(n)]
    code = ("import sys\n"
            "from gan_image_captioning_tpu_torch.data import bpe\n"
            "bpe.pre_tokenize(\"it's 42 caf\u00e9s!\")\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('regex', 'jax', 'gan_image_captioning_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
