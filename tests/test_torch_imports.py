"""The port stands alone and runs on the card unless asked otherwise.

``repro_torch`` imports neither JAX nor any module of the JAX package
(``repro``), at run time or in its source, and neither does
``chip_smoke.py``.  Its entry points default to the ``cuda`` backend and
raise without a CUDA device instead of moving to the CPU.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "src", "repro_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return [os.path.relpath(p, REPO) for p in out]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("rel", _sources())
def test_source_imports_no_jax_or_repro(rel):
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read(), rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{rel} imports {bad}"


def test_importing_every_module_loads_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(' '.join(names))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 44
    for kern in ("qgram_filter", "assign_lb", "bitunpack", "rank_popcount"):
        for part in ("kernel", "ops", "ref"):
            assert f"repro_torch.kernels.{kern}.{part}" in names


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _tiny_index():
    from repro_torch.core.search import FlatMSQIndex
    from repro_torch.graphs.generators import aids_like_db
    return FlatMSQIndex(aids_like_db(12, seed=1))


def test_default_engine_raises_without_cuda(no_cuda):
    from repro_torch.serve.graph_engine import GraphQueryEngine
    idx = _tiny_index()
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphQueryEngine(idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        idx.filter_eval()
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphQueryEngine(idx, backend="torch")     # the card by default
    with pytest.raises(ValueError):
        GraphQueryEngine(idx, backend="cuda", device="cpu")
    # the CPU is taken only when asked for
    assert GraphQueryEngine(idx, backend="torch",
                            device="cpu").device.type == "cpu"
    assert GraphQueryEngine(idx, backend="numpy").device is None


@pytest.mark.parametrize("backend", ["distributed", "pallas", "jax", "auto"])
def test_unported_backends_raise(backend):
    from repro_torch.core.engine import BatchedFilterEval
    from repro_torch.serve.graph_engine import GraphQueryEngine
    idx = _tiny_index()
    with pytest.raises(ValueError, match="backend"):
        GraphQueryEngine(idx, backend=backend)
    with pytest.raises(ValueError, match="backend"):
        BatchedFilterEval(idx.db, idx.enc, idx.partition, backend)


def test_has_nvcc_is_a_bool():
    from repro_torch.device import has_nvcc
    assert isinstance(has_nvcc(), bool)
