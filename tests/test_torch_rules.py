"""Rules of the PyTorch port: it stands alone, and it runs on the card
unless told otherwise."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from limbo_tpu_torch import kernels, means
from limbo_tpu_torch.models import gp as tgp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "limbo_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "limbo_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"the port imports the JAX stack: {bad}"


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, an entry point called without device='cpu' raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernels.SquaredExpARD.create(dim=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        means.DataMean.create()
    k = kernels.SquaredExpARD.create(dim=2, device="cpu")
    m = means.DataMean.create(device="cpu")
    X, Y = np.random.default_rng(0).uniform(size=(5, 2)), np.ones((5, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgp.fit(k, m, X, Y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgp.empty(k, m, 2)
    assert tgp.fit(k, m, X, Y, device="cpu").n == 5
