"""Fixtures of the harness's CPU tests: a checkout root that holds the
real harness with the cells cut to a few hundred vertices."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the cells' configurations at test size (urand at scale 9); every
#: other number as committed
TINY = {"chl_urand22": {"scale": 9, "n": 512}}


def make_root(dest: Path) -> Path:
    """A checkout root at ``dest``: BENCHMARK.json and a copy of
    chlbench/ with the configurations cut to test size."""
    shutil.copytree(ROOT / "chlbench", dest / "chlbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    for c in spec["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(TINY[c["name"]])
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
