"""The port's construction and repair launchers, the ``QueryServer``
shim and the serving launcher's query modes, against the reference.

``repro_torch.launch.chl.main`` and ``repro.launch.chl.main`` take the
same argv (the port's with ``--device cpu``) and must save artifacts
equal array for array (``ft.harness.assert_index_bit_identical``): the
hybrid with a checkpoint directory and its ``--resume``, PLaNT dense,
sharded and compressed (u16 exact), a road graph (the betweenness
ranking) served in qfdl, a DIMACS file, and a directed build.
``mutate_chl --verify-rebuild`` on an artifact the reference's launcher
wrote must save the reference's repaired artifact, also after an
interrupted repair (a pending journal, replayed) and when only the
journal's retirement was lost ("post"). ``QueryServer`` warns like the
reference's and answers and counts as it does; ``serve_chl`` answers
equally in qlsn, qfdl and qdol. Every comparison is exact.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.dynamic import RepairJournal as RefJournal
from repro.launch import chl as ref_chl
from repro.launch import mutate_chl as ref_mutate
from repro.launch import serve_chl as ref_serve_chl
from repro_torch.dynamic import RepairJournal
from repro_torch.ft import Fault, FaultPlan, InjectedCrash, faults
from repro_torch.ft.harness import assert_index_bit_identical
from repro_torch.graphs.io import write_dimacs
from repro_torch.launch import chl, mutate_chl, serve_chl

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
GRAPH = ["--graph", "scalefree", "--n", "80"]
SCALEFREE = GRAPH + ["--batch", "4"]


def lines(text, prefix):
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def run_both(argv, tmp_path, capsys):
    """Both launchers on ``argv``, each saving under its own directory;
    returns (port result, reference result, port dir, reference dir)
    after checking the artifacts and the graph and memory lines."""
    pdir, rdir = str(tmp_path / "port"), str(tmp_path / "ref")
    port = chl.main(argv + ["--save-index", pdir] + CPU)
    pout = capsys.readouterr().out
    ref = ref_chl.main(argv + ["--save-index", rdir])
    rout = capsys.readouterr().out
    assert_index_bit_identical(pdir, rdir)
    for prefix in ("graph n=", "memory:", "directed queries:"):
        assert lines(pout, prefix) == lines(rout, prefix), prefix
    assert port["als"] == ref["als"]
    return port, ref, pdir, rdir


# ---------------------------------------------------------- launch.chl

def test_chl_hybrid_checkpoint_resume_equals_reference(tmp_path, capsys):
    """The reference's slow launcher case: the hybrid with a checkpoint
    after every superstep, then ``--resume`` from the final cursor."""
    argv = SCALEFREE + ["--algo", "hybrid", "--queries", "64"]
    pck, rck = str(tmp_path / "pck"), str(tmp_path / "rck")
    port = chl.main(argv + ["--ckpt-dir", pck] + CPU)
    ref = ref_chl.main(argv + ["--ckpt-dir", rck])
    out = capsys.readouterr().out
    assert_index_bit_identical(os.path.join(pck, "index"),
                               os.path.join(rck, "index"))
    assert len(lines(out, "serving:")) == 2
    assert [s.mode for s in port["index"].report.supersteps] == \
        [s.mode for s in ref["index"].report.supersteps]
    again = chl.main(SCALEFREE + ["--algo", "hybrid", "--ckpt-dir", pck,
                                  "--resume", "--save-index",
                                  str(tmp_path / "again")] + CPU)
    assert_index_bit_identical(str(tmp_path / "again"),
                               os.path.join(rck, "index"))
    for a, b in zip(again["index"].table, port["index"].table):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv", [
    SCALEFREE + ["--algo", "plant", "--queries", "40"],
    SCALEFREE + ["--algo", "plant", "--store", "sharded", "--shards", "2",
                 "--queries", "40"],
    SCALEFREE + ["--algo", "plant", "--store", "compressed", "--codec",
                 "u16", "--quant-exact", "--shards", "2"],
    ["--graph", "road", "--n", "64", "--algo", "plant", "--batch", "8",
     "--queries", "40", "--query-mode", "qfdl"],
    ["--graph", "scalefree", "--n", "60", "--algo", "directed", "--batch",
     "4", "--queries", "32"]],
    ids=["plant-dense", "plant-sharded", "compressed-u16-exact",
         "road-qfdl", "directed"])
def test_chl_main_equals_reference(argv, tmp_path, capsys):
    port, ref, _, _ = run_both(argv, tmp_path, capsys)
    assert port["index"].directed == ref["index"].directed
    u = np.arange(port["index"].n)
    assert np.array_equal(port["index"].query(u, u[::-1]),
                          np.asarray(ref["index"].query(u, u[::-1])))


def test_chl_main_reads_dimacs_like_reference(tmp_path, capsys):
    path = str(tmp_path / "g.gr")
    write_dimacs(rg.scale_free(50, attach=2, seed=4), path)
    run_both(["--graph", path, "--algo", "plant", "--batch", "4",
              "--queries", "16", "--query-mode", "qdol"], tmp_path, capsys)


def test_chl_main_refuses_directed_road_like_reference():
    argv = ["--graph", "road", "--n", "16", "--algo", "directed"]
    with pytest.raises(SystemExit) as port:
        chl.main(argv + CPU)
    with pytest.raises(SystemExit) as ref:
        ref_chl.main(argv)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------- mutate_chl

MUTATE = GRAPH + ["--inserts", "2", "--deletes", "2", "--reweights",
                      "2", "--mut-seed", "4"]


@pytest.fixture(scope="module", params=["dense", "sharded"])
def ref_artifact(request, tmp_path_factory):
    """An artifact written by the reference's launcher, and the
    reference's repair of it (``mutate_chl --verify-rebuild``)."""
    d = tmp_path_factory.mktemp(f"ref_{request.param}")
    store = ([] if request.param == "dense"
             else ["--store", "sharded", "--shards", "2"])
    src = str(d / "index")
    ref_chl.main(SCALEFREE + ["--algo", "plant", "--save-index", src]
                 + store)
    repaired = str(d / "repaired")
    shutil.copytree(src, repaired)
    ref_mutate.main(MUTATE + ["--index", repaired, "--verify-rebuild"])
    return src, repaired


def test_mutate_verify_rebuild_equals_reference(ref_artifact, tmp_path,
                                                capsys):
    src, repaired = ref_artifact
    mine = str(tmp_path / "idx")
    shutil.copytree(src, mine)
    out = mutate_chl.main(MUTATE + ["--index", mine, "--verify-rebuild",
                                    "--queries", "64"] + CPU)
    text = capsys.readouterr().out
    assert "verify-rebuild: bit-identical" in text
    assert lines(text, "serving:")
    assert_index_bit_identical(mine, repaired)
    assert out["report"].affected > 0
    assert not os.path.exists(mine + ".repair_journal.json")


def test_mutate_replays_a_pending_journal(ref_artifact, tmp_path, capsys):
    """A repair interrupted at ``repair.merge`` leaves its journal; the
    next run classifies the artifact as pre-repair and replays the
    journaled batch to the reference's repaired artifact."""
    src, repaired = ref_artifact
    mine = str(tmp_path / "idx")
    shutil.copytree(src, mine)
    with faults(FaultPlan({"repair.merge": [Fault("crash")]})):
        with pytest.raises(InjectedCrash):
            mutate_chl.main(MUTATE + ["--index", mine] + CPU)
    assert RepairJournal.for_artifact(mine).pending() is not None
    assert_index_bit_identical(mine, src)
    capsys.readouterr()
    # a different --mut-seed: the replay must use the journal's batch
    out = mutate_chl.main(GRAPH + ["--index", mine, "--mut-seed", "9",
                                       "--verify-rebuild"] + CPU)
    text = capsys.readouterr().out
    assert "loaded artifact is pre-repair" in text
    assert "replaying journaled batch (6 mutations)" in text
    assert out["report"] is not None
    assert_index_bit_identical(mine, repaired)
    assert RepairJournal.for_artifact(mine).pending() is None


def test_mutate_post_journal_has_nothing_to_replay(ref_artifact, tmp_path,
                                                   capsys, monkeypatch):
    """The repaired artifact landed but the journal was never retired:
    the next run finds it "post", retires it and replays nothing, as the
    reference's launcher does."""
    src, repaired = ref_artifact
    results = []
    for pkg, journal, launcher, extra in (
            ("port", RepairJournal, mutate_chl, CPU),
            ("ref", RefJournal, ref_mutate, [])):
        d = str(tmp_path / pkg)
        shutil.copytree(src, d)
        with monkeypatch.context() as m:
            m.setattr(journal, "finish", lambda self: None)
            launcher.main(MUTATE + ["--index", d] + extra)
        assert journal.for_artifact(d).pending() is not None
        capsys.readouterr()
        out = launcher.main(MUTATE + ["--index", d] + extra)
        text = capsys.readouterr().out
        assert "loaded artifact is post-repair" in text
        assert "journal retired; artifact already repaired" in text
        assert out["report"] is None and out["batch"] is None
        assert journal.for_artifact(d).pending() is None
        assert_index_bit_identical(d, repaired)
        results.append(text.splitlines()[1:])
    assert results[0] == results[1]


# ------------------------------------------------- QueryServer shim

def _shim_case():
    """``tests/test_extensions.py``'s QueryServer case: grid_road(5, 5),
    PLaNT at batch 8, 150 queries in two submits, batches of 64."""
    from repro.graphs.ranking import degree_ranking
    g = rg.grid_road(5, 5, seed=1)
    rank = degree_ranking(g)
    rng = np.random.default_rng(0)
    u = rng.integers(0, g.n, 150).astype(np.int32)
    v = rng.integers(0, g.n, 150).astype(np.int32)
    return g, rank, u, v


def test_query_server_warns_answers_and_accounts_like_reference():
    import repro.index as ref_index
    from repro.serve import QueryServer as RefServer
    from repro_torch import interop
    from repro_torch.index import BuildPlan, build
    from repro_torch.serve import QueryServer, ServerStats, ServiceStats
    assert ServerStats is ServiceStats
    g, rank, u, v = _shim_case()
    ref_table = ref_index.build(g, rank, ref_index.BuildPlan(
        algo="plant", batch=8)).table
    table = build(interop.graph(g), rank, BuildPlan(algo="plant", batch=8),
                  device="cpu").table
    servers, messages = [], []
    for cls, tbl in ((QueryServer, table), (RefServer, ref_table)):
        with pytest.warns(DeprecationWarning) as rec:
            srv = cls.build(tbl, mode="qlsn", batch_size=64)
        messages.append([str(w.message) for w in rec])
        srv.submit(u[:100], v[:100])
        srv.submit(u[100:], v[100:])
        servers.append((srv, np.asarray(srv.flush())))
    (port, got), (ref, want) = servers
    assert np.array_equal(got, want)
    a, b = port.stats(), ref.stats()
    assert a["queries"] == b["queries"] == 150
    assert a["batches"] == b["batches"] == 3
    assert a["throughput_qps"] > 0
    assert messages[0] == [m.replace("repro.", "repro_torch.")
                           for m in messages[1]]
    with pytest.warns(DeprecationWarning, match="QueryServer is deprecated"):
        QueryServer(lambda uu, vv: uu.float(), batch_size=4)


@pytest.mark.parametrize("mode", ["qfdl", "qdol"])
def test_query_server_distributed_modes_equal_qlsn(mode):
    from repro_torch import interop
    from repro_torch.index import BuildPlan, build
    from repro_torch.parallel import NodeMesh
    from repro_torch.serve import QueryServer
    g, rank, u, v = _shim_case()
    table = build(interop.graph(g), rank, BuildPlan(algo="plant", batch=8),
                  device="cpu").table
    out = []
    for m, kw in (("qlsn", {}), (mode, {"mesh": NodeMesh.logical(3, "cpu"),
                                        "rank": rank})):
        with pytest.warns(DeprecationWarning):
            srv = QueryServer.build(table, mode=m, batch_size=64, **kw)
        srv.submit(u, v)
        out.append(srv.flush())
    assert np.array_equal(out[0], out[1])


# ------------------------------------------------ serve_chl, each mode

def test_serve_chl_answers_equally_in_every_mode(tmp_path, capsys):
    d = str(tmp_path / "idx")
    chl.main(SCALEFREE + ["--algo", "plant", "--save-index", d] + CPU)
    common = ["--index", d, "--queries", "300", "--batch-size", "64",
              "--seed", "3"]
    got = {}
    for mode in ("qlsn", "qfdl", "qdol"):
        out = serve_chl.main(common + ["--mode", mode] + CPU)
        assert out["stats"]["queries"] == 300
        got[mode] = out["distances"]
        assert re.search(rf"^{mode}: 300 queries",
                         capsys.readouterr().out, re.M)
    ref = ref_serve_chl.main(common + ["--mode", "qlsn"])
    for mode in got:
        assert np.array_equal(got[mode], np.asarray(ref["distances"])), mode


# ----------------------------------------------------- no silent CPU

def test_launchers_refuse_to_run_without_cuda(monkeypatch, tmp_path):
    from repro_torch.launch import ft_smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (chl.main, SCALEFREE + ["--algo", "plant"]),
            (mutate_chl.main, GRAPH + ["--index", str(tmp_path)]),
            (ft_smoke.main, ["--workdir", str(tmp_path / "ft")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
