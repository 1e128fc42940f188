"""Import boundary of the PyTorch port: no module of `qdiffusion_torch/`
and no line of `chip_smoke.py` imports jax or the JAX package, so the
port runs on a machine that has neither. Checked on the source (AST),
including imports inside functions and `importlib`/`__import__` calls
with a literal module name. Also: the port's CLI runs on the card by
default and raises, rather than falling back, where CUDA is absent."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "qdiffusion_tpu", "flax", "ml_dtypes")
SOURCES = sorted((ROOT / "qdiffusion_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "qdiffusion_torch/ops/groupnorm.py" in names
    assert "chip_smoke.py" in names and len(names) > 15


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(ln, m) for ln, m in _imported_names(tree) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_checker_catches_each_form():
    src = ("import jax\nfrom qdiffusion_tpu.nn import x\n"
           "def f():\n    import jax.numpy as jnp\n"
           "importlib.import_module('qdiffusion_tpu.cli')\n"
           "__import__('jaxlib')\nimport torch\nfrom . import nn\n")
    found = sorted(m for _, m in _imported_names(ast.parse(src))
                   if _forbidden(m))
    assert found == ["jax", "jax.numpy", "jaxlib", "qdiffusion_tpu.cli",
                     "qdiffusion_tpu.nn"]


@pytest.mark.parametrize("device_args", [[], ["--device", "cuda"]])
def test_cli_raises_without_cuda(tmp_path, monkeypatch, device_args):
    from qdiffusion_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["sample", "--task", "cifar10", "--n", "1",
                  "--npz-out", str(tmp_path / "x"), *device_args])
    assert not (tmp_path / "x").exists()
