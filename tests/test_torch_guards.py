"""Guards of the port: no JAX inside it, and no silent CPU fallback.

``src/repro_torch/`` and ``chip_smoke.py`` must import neither ``jax`` /
``jaxlib`` nor anything of the reference package ``repro`` (an AST scan of
every import, including imports inside functions).  A request for CUDA on
a machine without it raises instead of running on the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0], node.lineno


def test_port_scan_covers_the_package():
    names = {p.name for p in _port_files()}
    assert {"engine.py", "ops.py", "layers.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    cfg = get_config("gemma2-2b-smoke")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg)                       # default device: cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_paged_cache(cfg, 4, 4)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_weight_conversion_defaults_to_cuda(monkeypatch):
    """Carrying the reference's weights across lands them on the card by
    default; with CUDA missing that raises instead of serving from the
    CPU."""
    from repro_torch import weights
    cfg = get_config("gemma2-2b-smoke")
    tree = {"embed": np.zeros((4, 2), np.float32),
            "segments": [{f"l{j}": {"w": np.zeros((1, 2), np.float32)}
                          for j in range(2)}]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights.from_jax_params(tree, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights.unstack_layers(tree["segments"], cfg)
    got = weights.from_jax_params(tree, cfg, device="cpu")
    assert got["embed"].device == torch.device("cpu")
    assert len(got["layers"]) == cfg.num_layers


def test_serve_cli_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import serve as serve_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", "gemma2-2b-smoke", "--requests", "1"])
