"""Mutate -> repair launcher over a saved ``CHLIndex`` artifact.

    python -m repro_torch.launch.mutate_chl --index run/index \
        --graph road --n 1600 --seed 0 \
        --inserts 2 --deletes 2 --reweights 4 --verify-rebuild

Loads the artifact written by ``repro_torch.launch.chl`` (or the
reference's launcher) onto ``--device`` (default: the card; it raises
without CUDA), regenerates the graph it was built on (the same
``--graph/--n/--seed`` contract: the rank-hash check rejects a
mismatched hierarchy, which also catches wrong graph parameters),
draws a seeded :class:`repro_torch.dynamic.MutationBatch`, and repairs
the index in place through ``CHLIndex.apply`` under a
:class:`~repro_torch.dynamic.RepairJournal`. ``--verify-rebuild`` also
runs a from-scratch PLaNT build on the mutated graph and asserts the
repaired label arrays are **bit-identical**: the dynamic subsystem's
acceptance gate, runnable against any artifact. ``--save-index``
(default: overwrite in place) persists the repaired artifact so
``repro_torch.launch.serve_chl`` serves post-mutation answers.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.dynamic import RepairJournal, random_mutations
from repro_torch.index import CHLIndex, build
from repro_torch.launch.chl import build_graph


def _assert_rebuild_parity(idx: CHLIndex, g_new, rep) -> None:
    """Bit-identity gate: a fresh PLaNT build on the mutated graph, at
    the repaired store's own layout and on its device, must match
    array for array (padding included); host copies are compared."""
    plan = dataclasses.replace(
        idx.plan, algo="plant", store=idx.store.kind,
        shards=(idx.store.num_shards
                if idx.store.kind == "sharded" else None),
        cap=rep.cap)
    ref = build(g_new, idx.rank, plan, device=idx.store.device)
    for (k, a), (_, b) in zip(idx.store.shard_arrays(),
                              ref.store.shard_arrays()):
        for key in ("hubs", "dist", "count"):
            if not np.array_equal(np.asarray(a[key]),
                                  np.asarray(b[key])):
                raise SystemExit(
                    f"repair/rebuild divergence in shard {k} {key} — "
                    "the repaired index is NOT bit-identical")
    rng = np.random.default_rng(7)
    u = rng.integers(0, idx.n, 512)
    v = rng.integers(0, idx.n, 512)
    if not np.array_equal(idx.query(u, v), ref.query(u, v)):
        raise SystemExit("repair/rebuild qlsn answer divergence")
    print(f"verify-rebuild: bit-identical "
          f"({idx.total_labels} labels, store={idx.store.kind})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True,
                    help="CHLIndex artifact directory (from "
                         "repro_torch.launch.chl)")
    ap.add_argument("--graph", default="road",
                    help="road | scalefree | <path.gr> — must match "
                         "the build (rank-hash checked)")
    ap.add_argument("--n", type=int, default=1600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inserts", type=int, default=1)
    ap.add_argument("--deletes", type=int, default=1)
    ap.add_argument("--reweights", type=int, default=1)
    ap.add_argument("--mut-seed", type=int, default=0,
                    help="mutation-draw seed (reproducible batches)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the repair wave per committed "
                         "superstep (kind='repair' states)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-index", default=None,
                    help="where to save the repaired artifact "
                         "(default: overwrite --index in place)")
    ap.add_argument("--verify-rebuild", action="store_true",
                    help="assert bit-identity vs a from-scratch "
                         "build on the mutated graph")
    ap.add_argument("--queries", type=int, default=0,
                    help="post-repair qlsn smoke queries")
    ap.add_argument("--device", default=None,
                    help="device to repair on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    g, rank = build_graph(args)
    # rank-hash checked: a wrong --graph/--n/--seed fails loudly here
    idx = CHLIndex.load(args.index, rank=rank, device=dev)
    print(f"loaded index: n={idx.n} labels={idx.total_labels} "
          f"store={idx.store.kind}/{idx.store.num_shards}")

    out_dir = args.save_index or args.index
    # crash-atomic apply: intent + pre/post store fingerprints live in
    # a sibling journal until the repaired artifact swap lands, so an
    # interrupted run is classified (pre/post) and replayed on restart
    journal = RepairJournal.for_artifact(out_dir)
    if journal.pending() is not None:
        state = journal.recover(idx)
        print(f"unfinished repair journal found: loaded artifact is "
              f"{state}-repair")
        if state == "post":
            # the previous run's atomic swap landed; only the journal
            # retirement was lost — nothing to replay
            print("journal retired; artifact already repaired")
            return {"report": None, "index": idx, "batch": None,
                    "graph_new": None}
        batch = journal.batch()
        journal.finish()
        print(f"replaying journaled batch ({len(batch)} mutations)")
    else:
        rng = np.random.default_rng(args.mut_seed)
        batch = random_mutations(g, rng, inserts=args.inserts,
                                 deletes=args.deletes,
                                 reweights=args.reweights)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    rep = idx.apply(batch, graph=g, ckpt=mgr, resume=args.resume,
                    verbose=True, journal=journal)
    print(f"repair done: {rep.summary()}")

    g_new = batch.apply(g)
    if args.verify_rebuild:
        _assert_rebuild_parity(idx, g_new, rep)

    idx.save(out_dir)
    journal.finish()
    print(f"repaired artifact saved to {out_dir}")

    if args.queries:
        qrng = np.random.default_rng(1)
        svc = idx.serve(mode="qlsn", batch_size=256)
        svc.warmup(buckets=args.queries % 256 != 0)
        svc.submit(qrng.integers(0, g.n, args.queries),
                   qrng.integers(0, g.n, args.queries))
        svc.flush()
        print("serving:", svc.stats())
    return {"report": rep, "index": idx, "batch": batch,
            "graph_new": g_new}


if __name__ == "__main__":
    main()
