"""Fault-injection smoke: a crash-kill matrix over build -> repair ->
serve.

    PYTHONPATH=src python -m repro_torch.launch.ft_smoke --workdir ft

The parent orchestrates; every build/repair runs as a **subprocess**
(re-invoking this module with ``--child``, on the parent's
``--device``) so an injected ``Fault("crash", hard=True)`` really drops
the process with ``os._exit`` at the named site (no unwinding, no
flushing) and recovery is exercised from cold on-disk state. The
matrix:

1. reference: uninterrupted streaming sharded PLaNT build;
2. crash-kill the build at ``checkpoint.commit`` (torn checkpoint on
   disk) -> resume -> artifact **bit-identical** to the reference;
3. crash-kill the build at ``artifact.save.commit`` (inside the staged
   swap: the artifact directory must never appear) -> resume from the
   final checkpoint -> bit-identical;
4. crash-kill a journaled repair at ``repair.merge`` -> the sibling
   journal classifies the artifact as pre-repair -> replay ->
   bit-identical to an uninterrupted repair;
5. flip one byte in a shard -> ``CHLIndex.load`` raises
   ``CorruptArtifactError`` (never a wrong answer);
6. serve smoke: the repaired artifact answers queries with
   ``health() == ok``; a poisoned answer fn trips the circuit breaker
   into fail-fast ``CircuitOpenError`` with ``health() ==
   unavailable``.

``--device`` defaults to the card (it raises without CUDA); ``cpu``
runs the plain PyTorch path. Exit code 0 = every leg passed. Any
assertion prints and exits 1.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.ft.harness import (assert_child_killed, assert_child_ok,
                                    assert_index_bit_identical, run_child)
from repro_torch.ft.inject import Fault, FaultPlan

#: deterministic mutation draw shared by the repair children
MUT_SEED = 3


# ----------------------------------------------------------- children

def _child_build(args) -> None:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.index import BuildPlan, build
    from repro_torch.launch.chl import build_graph

    g, rank = build_graph(args)
    plan = BuildPlan(algo="plant", batch=8, store="sharded", shards=2)
    mgr = CheckpointManager(args.ckpt_dir)
    idx = build(g, rank, plan, device=args.device, ckpt=mgr,
                resume=args.resume)
    idx.save(args.out)
    print(f"child build: saved {idx.total_labels} labels to "
          f"{args.out}")


def _child_repair(args) -> None:
    from repro_torch.dynamic import RepairJournal, random_mutations
    from repro_torch.index import CHLIndex
    from repro_torch.launch.chl import build_graph

    g, rank = build_graph(args)
    idx = CHLIndex.load(args.index, rank=rank, device=args.device)
    journal = RepairJournal.for_artifact(args.index)
    if journal.pending() is not None:
        state = journal.recover(idx)
        print(f"child repair: journal found, artifact is {state}")
        if state == "post":
            journal.finish()
            return
        batch = journal.batch()
        journal.finish()
    else:
        rng = np.random.default_rng(MUT_SEED)
        batch = random_mutations(g, rng, inserts=2, deletes=2,
                                 reweights=2)
    idx.apply(batch, graph=g, journal=journal)
    idx.save(args.index)
    journal.finish()
    print(f"child repair: saved {idx.total_labels} labels to "
          f"{args.index}")


# ------------------------------------------------------------- matrix

def _run_matrix(args) -> None:
    dev = resolve_device(args.device)
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    common = ["-m", "repro_torch.launch.ft_smoke", "--graph", args.graph,
              "--n", str(args.n), "--seed", str(args.seed),
              "--device", str(dev)]

    def build_argv(ckpt, out, resume=False):
        argv = common + ["--child", "build", "--ckpt-dir", ckpt,
                         "--out", out]
        return argv + ["--resume"] if resume else argv

    def repair_argv(index):
        return common + ["--child", "repair", "--index", index]

    ref = os.path.join(wd, "ref_index")

    print("[1/6] reference build (uninterrupted)")
    assert_child_ok(run_child(
        build_argv(os.path.join(wd, "ref_ckpt"), ref)))

    print("[2/6] crash-kill build at checkpoint.commit, resume")
    out_a = os.path.join(wd, "a_index")
    ckpt_a = os.path.join(wd, "a_ckpt")
    plan = FaultPlan(
        {"checkpoint.commit": [Fault("crash", after=2, hard=True)]})
    assert_child_killed(run_child(build_argv(ckpt_a, out_a),
                                  plan=plan))
    assert not os.path.exists(out_a), \
        "artifact appeared despite the crash-killed build"
    assert_child_ok(run_child(build_argv(ckpt_a, out_a, resume=True)))
    assert_index_bit_identical(out_a, ref)

    print("[3/6] crash-kill build inside the artifact staged swap, "
          "resume")
    out_b = os.path.join(wd, "b_index")
    ckpt_b = os.path.join(wd, "b_ckpt")
    plan = FaultPlan(
        {"artifact.save.commit": [Fault("crash", hard=True)]})
    assert_child_killed(run_child(build_argv(ckpt_b, out_b),
                                  plan=plan))
    assert not os.path.exists(out_b), \
        "staged swap landed a partial artifact"
    assert_child_ok(run_child(build_argv(ckpt_b, out_b, resume=True)))
    assert_index_bit_identical(out_b, ref)

    print("[4/6] crash-kill journaled repair at repair.merge, replay")
    r_ref = os.path.join(wd, "repair_ref")
    r_crash = os.path.join(wd, "repair_crash")
    shutil.copytree(ref, r_ref)
    shutil.copytree(ref, r_crash)
    assert_child_ok(run_child(repair_argv(r_ref)))
    plan = FaultPlan({"repair.merge": [Fault("crash", hard=True)]})
    assert_child_killed(run_child(repair_argv(r_crash), plan=plan))
    journal_path = r_crash.rstrip(os.sep) + ".repair_journal.json"
    assert os.path.exists(journal_path), \
        "crash left no repair journal behind"
    assert_child_ok(run_child(repair_argv(r_crash)))
    assert not os.path.exists(journal_path), \
        "journal not retired after successful replay"
    assert_index_bit_identical(r_crash, r_ref)

    print("[5/6] bit-flipped shard is rejected at load")
    from repro_torch.index import CHLIndex
    from repro_torch.index.store import CorruptArtifactError, shard_filename
    from repro_torch.launch.chl import build_graph
    flipped = os.path.join(wd, "flipped_index")
    shutil.copytree(ref, flipped)
    shard = os.path.join(flipped, shard_filename(0))
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x40]))
    g, rank = build_graph(args)
    try:
        CHLIndex.load(flipped, rank=rank, device=dev)
    except CorruptArtifactError as e:
        print(f"    rejected as expected: {e}")
    else:
        raise AssertionError(
            "bit-flipped shard loaded without CorruptArtifactError")

    print("[6/6] serve smoke: healthy answers + breaker trip")
    from repro_torch.serve import CircuitOpenError, QueryService
    idx = CHLIndex.load(r_ref, rank=rank, device=dev)
    svc = idx.serve(mode="qlsn", batch_size=64)
    qrng = np.random.default_rng(11)
    u = qrng.integers(0, idx.n, 256)
    v = qrng.integers(0, idx.n, 256)
    svc.submit(u, v)
    got = svc.flush()
    if not np.array_equal(got, np.asarray(idx.query(u, v),
                                          dtype=np.float32)):
        raise AssertionError("served answers diverge from idx.query")
    health = svc.health()
    assert health["status"] == "ok", f"unexpected health: {health}"

    def poisoned(uu, vv):
        raise RuntimeError("poisoned kernel")

    bad = QueryService(poisoned, batch_size=4, breaker_threshold=2,
                       breaker_reset_s=60.0)
    for i in range(8):
        bad.try_submit(i, i + 1)
    bad.drain()
    try:
        bad.try_submit(0, 1)
    except CircuitOpenError:
        pass
    else:
        raise AssertionError("breaker did not open after repeated "
                             "answer failures")
    health = bad.health()
    assert health["status"] == "unavailable", \
        f"tripped breaker not visible: {health}"
    assert health["breaker_trips"] >= 1 and health["answer_failures"] \
        >= 2, f"fault counters missing: {health}"

    print("ft_smoke: all 6 legs passed")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ft_smoke"))
    ap.add_argument("--graph", default="road")
    ap.add_argument("--n", type=int, default=144)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device of every build, repair and load "
                         "(default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch path); passed on to the children")
    ap.add_argument("--child", choices=["build", "repair"],
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--index", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child == "build":
        _child_build(args)
    elif args.child == "repair":
        _child_repair(args)
    else:
        if os.path.exists(args.workdir):
            shutil.rmtree(args.workdir)
        _run_matrix(args)


if __name__ == "__main__":
    main()
