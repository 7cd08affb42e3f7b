"""Rules of the PyTorch/CUDA port.

- ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of the reference package ``repro``;
- the entry points default to the card and raise without CUDA instead
  of running on the CPU;
- CPU tensors never launch a kernel (the launch counts stay at 0);
- narrow storage dtypes of label arrays appear only in the codec layer
  (``index/quant/`` and ``index/store/``);
- the per-algorithm ``*_chl`` constructors are the deprecated engine
  layer: ``repro_torch.core`` re-exports them behind the reference's
  ``DeprecationWarning``, and no module outside ``repro_torch/core/``
  and ``repro_torch/index/`` (nor the top-level scripts) imports them.
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
                   "dynamic/repair.py", "dynamic/journal.py",
                   "core/directed.py", "parallel/sharding.py",
                   "index/store/sharded.py", "serve/routing.py",
                   "index/quant/codecs.py", "index/quant/deltas.py",
                   "index/store/spill.py", "index/store/compressed.py",
                   "serve/loadgen.py", "launch/serve_chl.py",
                   "configs/chl_common.py", "configs/chl_road.py",
                   "configs/chl_scalefree.py", "parallel/mesh.py",
                   "parallel/collectives.py", "core/dgll.py",
                   "core/hybrid.py", "core/query.py", "engine/dist.py",
                   "ft/elastic.py"):
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
    # the spill and compressed residencies and the serving launcher
    for store in ("spill", "compressed"):
        with pytest.raises(RuntimeError, match="CUDA"):
            CHLIndex.load(path, store=store)
        assert CHLIndex.load(path, store=store, device="cpu").n == g.n
    with pytest.raises(RuntimeError, match="CUDA"):
        build(g, rank, BuildPlan(algo="plant", store="compressed"))
    from repro_torch.launch import serve_chl
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_chl.main(["--index", path, "--queries", "8"])
    assert serve_chl.main(["--index", path, "--queries", "8",
                           "--device", "cpu"])["stats"]["queries"] == 8


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


def test_directed_and_sharded_paths_default_to_the_card(no_cuda):
    """The directed and sharded entry points refuse without CUDA, and
    their CPU paths launch no kernel."""
    from repro_torch.core.directed import plant_directed_chl
    from repro_torch.graphs import random_connected
    from repro_torch.index.store import DenseStore, ShardedStore
    gd = random_connected(12, extra_edges=10, seed=0, directed=True)
    g = grid_road(3, 4, seed=0)
    rank = degree_ranking(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        plant_directed_chl(gd, degree_ranking(gd))
    with pytest.raises(RuntimeError, match="CUDA"):
        build(g, rank, BuildPlan(algo="plant", store="sharded", shards=2))
    shard = {"hubs": np.full((2, 1), -1, np.int32),
             "dist": np.full((2, 1), np.inf, np.float32),
             "count": np.zeros(2, np.int32)}
    for store in (ShardedStore, DenseStore):
        with pytest.raises(RuntimeError, match="CUDA"):
            store.from_shard_arrays([shard, shard])
    kernels = all_kernels()
    before = [k.launches for k in kernels]
    di = build(gd, degree_ranking(gd), BuildPlan(algo="directed", batch=4),
               device="cpu")
    sh = build(g, rank, BuildPlan(algo="plant", store="sharded", shards=2),
               device="cpu")
    for idx in (di, sh):
        srv = idx.serve(batch_size=8)
        srv.submit(np.arange(idx.n), np.arange(idx.n)[::-1])
        assert np.isfinite(srv.flush()).all()
    assert [k.launches for k in kernels] == before == [0] * len(kernels)


def test_kernel_sources_are_in_the_package():
    for k in all_kernels():
        assert k.source.is_file() and k.source.suffix == ".cu"
        text = k.source.read_text()
        assert f"{k.name}_launch" in text and "Replaces:" in text


#: storage-dtype tokens banned outside the codec layer
_BANNED = ("uint8", "uint16", "uint32", "bfloat16", "float16",
           "bitcast_convert_type")

#: label-touching packages of the port the ban applies to
_LABEL_CODE = tuple(f"src/repro_torch/{d}/" for d in
                    ("serve", "engine", "dynamic", "parallel", "index"))

#: the codec layer itself — the only place storage dtypes may appear
_CODEC_LAYER = ("src/repro_torch/index/quant/",
                "src/repro_torch/index/store/")


def test_no_label_dtype_casts_outside_codec_layer():
    """The port's counterpart of the reference's rule: narrow storage
    dtypes of label arrays live only in index/quant and index/store, so
    codec logic cannot leak into serve/engine code."""
    offenders = []
    for path in PORT_FILES:
        rel = path.relative_to(ROOT).as_posix()
        if not rel.startswith(_LABEL_CODE) or rel.startswith(_CODEC_LAYER):
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if any(tok in line for tok in _BANNED):
                offenders.append(f"{rel}:{i}: {line.strip()}")
    assert not offenders, (
        "storage-dtype use on label code outside the codec layer:\n  "
        + "\n  ".join(offenders))
    scanned = [p for p in PORT_FILES
               if p.relative_to(ROOT).as_posix().startswith(_CODEC_LAYER)]
    assert any("uint16" in p.read_text() for p in scanned)


def test_spill_and_compressed_paths_launch_no_kernel_on_the_cpu(tmp_path):
    """CPU spill and compressed stores answer through the plain version:
    no launch count moves."""
    kernels = all_kernels()
    before = [k.launches for k in kernels]
    g = grid_road(4, 5, seed=1)
    rank = degree_ranking(g)
    idx = build(g, rank, BuildPlan(algo="plant", batch=4, store="sharded",
                                   shards=2), device="cpu")
    path = idx.save(str(tmp_path / "idx"))
    u = np.arange(g.n)
    for store in ("spill", "compressed"):
        loaded = CHLIndex.load(path, store=store, device="cpu")
        srv = loaded.serve(batch_size=8)
        srv.submit(u, u[::-1])
        assert np.array_equal(srv.flush(), idx.query(u, u[::-1]))
    assert [k.launches for k in kernels] == before == [0] * len(kernels)


SHIM_NAMES = ("plant_chl", "gll_chl", "lcc_chl", "parapll_chl", "dgll_chl",
              "hybrid_chl", "plant_distributed_chl")


def test_no_engine_shim_call_sites_outside_index():
    """The port's counterpart of the reference's
    ``test_store.py::test_no_engine_shim_call_sites_outside_index``: the
    ``*_chl`` constructors are the deprecated engine layer, imported by
    nothing but their defining package (``repro_torch/core/``) and the
    facade (``repro_torch/index/``), and by the tests."""
    import re
    import_pat = re.compile(
        r"from\s+repro_torch\.core(?:\.\w+)?\s+import\s+[^\n]*\b("
        + "|".join(SHIM_NAMES) + r")\b")
    call_pat = re.compile(r"\b(?:core|gll|dgll|hybrid|plant)\.("
                          + "|".join(SHIM_NAMES) + r")\(")
    offenders = []
    for path in PORT_FILES + [ROOT / "kernel_ab.py"]:
        rel = path.relative_to(ROOT).as_posix()
        if rel.startswith(("src/repro_torch/core/",
                           "src/repro_torch/index/")):
            continue
        text = path.read_text()
        for pat in (import_pat, call_pat):
            m = pat.search(text)
            if m:
                offenders.append(f"{rel}: uses engine shim {m.group(1)}")
    assert not offenders, (
        "deprecated engine-layer shims used outside repro_torch/index and "
        "tests:\n  " + "\n  ".join(offenders))


@pytest.mark.parametrize("name", SHIM_NAMES)
def test_core_shims_warn_like_the_reference(name):
    """Each ``repro_torch.core.*_chl`` re-export emits the reference's
    ``DeprecationWarning``, word for word with ``repro_torch`` for
    ``repro``, before it runs (here on a non-graph, which then fails, or,
    for the port's distributed ones, refuses without a card)."""
    import repro.core as ref_core
    import repro_torch.core as port_core
    msgs = []
    for mod in (ref_core, port_core):
        with pytest.warns(DeprecationWarning) as rec:
            with pytest.raises((AttributeError, RuntimeError)):
                getattr(mod, name)(None, np.zeros(1, np.int32))
        msgs.append(str(rec[0].message))
    ref_msg, port_msg = msgs
    assert ref_msg.startswith(f"repro.core.{name} is a deprecated")
    assert port_msg == ref_msg.replace("repro.", "repro_torch.")
    # the defining modules stay warning-free and build
    g = grid_road(3, 4, seed=0)
    rank = degree_ranking(g)
    import warnings
    from repro_torch.core import dgll, gll, hybrid, plant
    from repro_torch.parallel import NodeMesh
    fn = next(getattr(m, name) for m in (plant, gll, dgll, hybrid)
              if hasattr(m, name))
    kw = ({"mesh": NodeMesh(["cpu"])} if name in ("dgll_chl", "hybrid_chl",
                                                  "plant_distributed_chl")
          else {"device": "cpu"})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        table, _ = fn(g, rank, **kw)
    with pytest.warns(DeprecationWarning):
        again, _ = getattr(port_core, name)(g, rank, **kw)
    assert all(torch.equal(a, b) for a, b in zip(table, again))


def test_entry_points_and_examples_are_scanned():
    """The import scan above covers the launchers and the examples."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("graphs/io.py", "serve/query_server.py",
                   "launch/chl.py", "launch/mutate_chl.py",
                   "launch/ft_smoke.py", "launch/serve_chl.py",
                   "examples/quickstart.py", "examples/dynamic_repair.py",
                   "examples/serve_chl_queries.py",
                   "examples/elastic_failover.py",
                   # the LM zoo's serving path
                   "configs/base.py", "configs/smollm_360m.py",
                   "configs/whisper_base.py", "configs/qwen3_moe_235b_a22b.py",
                   "configs/dbrx_132b.py", "configs/stablelm_1_6b.py",
                   "configs/stablelm_12b.py", "configs/yi_34b.py",
                   "configs/llama32_vision_90b.py", "configs/xlstm_125m.py",
                   "configs/jamba15_large_398b.py", "models/common.py",
                   "models/layers.py", "models/moe.py", "models/mamba.py",
                   "models/xlstm.py", "models/decoder.py", "models/model.py",
                   "train/trainer.py", "launch/serve.py",
                   "examples/serve_lm.py"):
        assert f"src/repro_torch/{module}" in names


def test_lm_entry_points_refuse_to_run_without_cuda(no_cuda):
    """The LM serving path defaults to the card like the CHL entry
    points; ``device="cpu"`` runs it, and launches no kernel."""
    from repro_torch.configs import base
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    from repro_torch.models import init_params, init_serve_state
    cfg = base.get("smollm_360m").smoke
    argv = ["--smoke", "--batch", "1", "--prompt-len", "4", "--gen", "2"]
    for call in (lambda: init_params(cfg), lambda: serve.main(argv),
                 lambda: serve_lm.main(),
                 lambda: init_serve_state(cfg, 1, 4),
                 lambda: interop.lm_params(cfg, {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    kernels = all_kernels()
    before = [k.launches for k in kernels]
    assert serve.main(argv + ["--device", "cpu"])["tokens"].shape == (1, 2)
    assert [k.launches for k in kernels] == before == [0] * len(kernels)


def test_no_query_server_call_sites_outside_serve():
    """The reference's ban (``test_store.py``) on the deprecated
    ``QueryServer``: nothing in the package (its launchers and examples
    included) outside ``repro_torch/serve/`` constructs one, and nothing
    outside its own module calls ``QueryServer.build``. Like the tests,
    ``chip_smoke.py`` drives the shim on purpose."""
    offenders = []
    package = [p for p in PORT_FILES if p.name != "chip_smoke.py"]
    assert len(package) == len(PORT_FILES) - 1
    for path in package:
        rel = path.relative_to(ROOT).as_posix()
        text = path.read_text()
        if ("QueryServer.build" in text
                and rel != "src/repro_torch/serve/query_server.py"):
            offenders.append(f"{rel}: calls QueryServer.build")
        if ("QueryServer(" in text
                and not rel.startswith("src/repro_torch/serve/")):
            offenders.append(f"{rel}: constructs deprecated QueryServer")
    assert not offenders, "\n  ".join(offenders)


def test_networkx_is_imported_only_by_to_networkx():
    """networkx is a test oracle: only ``graphs.graph.to_networkx``
    imports it, inside the function (the card's machine has none)."""
    found = []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        owner = {}
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for sub in ast.walk(fn):
                    owner.setdefault(id(sub), fn.name)
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            if any(m.split(".")[0] == "networkx" for m in mods):
                found.append((path.relative_to(ROOT).as_posix(),
                              owner.get(id(node))))
    assert found == [("src/repro_torch/graphs/graph.py", "to_networkx")]


def test_lm_training_modules_are_scanned():
    """The import scan above covers the LM training slice."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("optim/__init__.py", "optim/adamw.py",
                   "data/__init__.py", "data/pipeline.py",
                   "train/__init__.py", "train/trainer.py",
                   "launch/train.py", "examples/train_lm.py", "interop.py",
                   "models/model.py", "checkpoint/manager.py"):
        assert f"src/repro_torch/{module}" in names


def test_lm_training_entry_points_refuse_to_run_without_cuda(no_cuda,
                                                             tmp_path):
    """``launch.train``, ``examples.train_lm``, ``init_train_state`` and
    ``interop.train_state`` default to the card and raise without CUDA;
    ``device="cpu"`` trains, and launches no kernel."""
    from repro_torch.configs import base
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, state_tree
    cfg = base.get("smollm_360m").smoke
    ocfg = AdamWConfig()
    argv = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "8"]
    cpu_state = init_train_state(cfg, ocfg, device="cpu")
    for call in (lambda: train.main(argv), lambda: train_lm.main(),
                 lambda: init_train_state(cfg, ocfg),
                 lambda: interop.train_state(cfg, ocfg,
                                             state_tree(cpu_state))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    kernels = all_kernels()
    before = [k.launches for k in kernels]
    out = train.main(argv + ["--device", "cpu", "--ckpt-dir",
                             str(tmp_path / "ckpt")])
    assert len(out["losses"]) == 2
    assert [k.launches for k in kernels] == before == [0] * len(kernels)


def test_lm_training_path_has_no_compile_and_no_fallback():
    """No ``torch.compile`` anywhere in the port, and no ``try`` in the
    training path's modules (a step that fails raises)."""
    for path in PORT_FILES:
        assert "torch.compile" not in path.read_text(), path
    pkg = ROOT / "src" / "repro_torch"
    for module in ("optim/adamw.py", "train/trainer.py", "launch/train.py",
                   "models/model.py", "models/decoder.py",
                   "examples/train_lm.py"):
        tree = ast.parse((pkg / module).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), \
            module


#: figures of the reference's TPU (v5e peak, HBM and ICI rates)
TPU_FIGURES = ("197e12", "819e9", "49.5e9", "ICI_BW", "v5e", "TPU")


def test_dryrun_modules_are_scanned_and_state_no_tpu_figure():
    """The import scan above covers the dry-run and sharding slice, and
    none of its modules states a TPU figure."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    modules = ("parallel/logical.py", "parallel/dtensor.py",
               "parallel/sharding.py", "launch/mesh.py", "launch/specs.py",
               "launch/dryrun.py", "roofline/__init__.py",
               "roofline/analysis.py", "train/trainer.py")
    for module in modules:
        path = f"src/repro_torch/{module}"
        assert path in names
        text = (ROOT / path).read_text()
        for fig in TPU_FIGURES:
            assert fig not in text, (module, fig)
