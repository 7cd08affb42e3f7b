"""Rules of the PyTorch/CUDA port.

- ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of the reference package ``repro``;
- the entry points default to the card and raise without CUDA instead
  of running on the CPU;
- CPU tensors never launch a kernel (the launch counts stay at 0).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.graphs import device_arrays, grid_road
from repro_torch.graphs.ranking import degree_ranking
from repro_torch.index import BuildPlan, CHLIndex, build
from repro_torch.kernels import all_kernels

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_port_tree_is_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/kernels/ell_relax/ell_relax.py" in names
    assert "src/repro_torch/kernels/label_query/label_query.py" in names
    assert "src/repro_torch/kernels/ell_relax/windowed.py" in names
    assert "src/repro_torch/kernels/minplus/minplus.py" in names
    for module in ("checkpoint/manager.py", "ft/inject.py", "ft/harness.py",
                   "dynamic/mutations.py", "dynamic/frontier.py",
                   "dynamic/repair.py", "dynamic/journal.py"):
        assert f"src/repro_torch/{module}" in names
    assert len(names) > 20


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_run_without_cuda(no_cuda, tmp_path):
    g = grid_road(3, 3, seed=0)
    rank = degree_ranking(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        build(g, rank, BuildPlan(algo="plant"))
    with pytest.raises(RuntimeError, match="CUDA"):
        device_arrays(g, rank)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.label_table(np.zeros((1, 1)), np.zeros((1, 1)),
                            np.zeros(1))
    idx = build(g, rank, BuildPlan(algo="plant"), device="cpu")
    path = idx.save(str(tmp_path / "idx"))
    with pytest.raises(RuntimeError, match="CUDA"):
        CHLIndex.load(path)
    assert CHLIndex.load(path, device="cpu").n == g.n


def test_cpu_path_launches_no_kernel():
    kernels = all_kernels()
    before = [k.launches for k in kernels]
    g = grid_road(4, 5, seed=1)
    rank = degree_ranking(g)
    idx = build(g, rank, BuildPlan(algo="plant", batch=4), device="cpu")
    srv = idx.serve(batch_size=8)
    srv.submit(np.arange(g.n), np.arange(g.n)[::-1])
    out = srv.flush()
    assert np.isfinite(out).all()
    assert [k.launches for k in kernels] == before == [0] * len(kernels)


def test_kernel_sources_are_in_the_package():
    for k in all_kernels():
        assert k.source.is_file() and k.source.suffix == ".cu"
        text = k.source.read_text()
        assert f"{k.name}_launch" in text and "Replaces:" in text
