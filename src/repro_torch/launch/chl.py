"""CHL-construction launcher with mid-run checkpointing.

    python -m repro_torch.launch.chl --graph road --n 1600 --algo hybrid \
        --ckpt-dir run --queries 1000

Thin CLI over ``repro_torch.index.build`` on ``--device`` (default: the
card; it raises without CUDA; ``cpu`` runs the plain PyTorch path):
parses a ``BuildPlan``, runs the facade (every algorithm through the
``repro_torch.engine`` superstep engine; the distributed family on one
node per visible card), finalizes the run into a versioned ``CHLIndex``
artifact (``--save-index``, default ``<ckpt-dir>/index``), and
optionally smoke-serves queries through ``CHLIndex.serve``.

Fault tolerance: with ``--ckpt-dir``, the engine checkpoints the label
state + superstep cursor after every committed superstep, for every
algorithm, and ``--resume`` continues from the last committed
superstep. A ``--store sharded`` PLaNT build streams each superstep's
labels straight into hub-partitioned shard arrays (the dense
``[n, cap]`` table is never materialized), and its checkpoints hold
the per-shard arrays.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.graphs import grid_road, scale_free
from repro_torch.graphs.io import read_dimacs
from repro_torch.graphs.ranking import betweenness_ranking, degree_ranking
from repro_torch.index import ALGOS, BuildPlan, build


def build_graph(args, directed: bool = False):
    """The graph and ranking named by ``--graph/--n/--seed``."""
    if args.graph == "road":
        if directed:
            raise SystemExit("--algo directed needs --graph scalefree "
                             "or a directed .gr file")
        side = int(np.sqrt(args.n))
        g = grid_road(side, side, seed=args.seed)
        rank = betweenness_ranking(g, samples=16)
    elif args.graph == "scalefree":
        g = scale_free(args.n, attach=2, seed=args.seed,
                       directed=directed)
        rank = degree_ranking(g)
    else:
        g = read_dimacs(args.graph, directed=directed)
        rank = degree_ranking(g)
    return g, rank


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="road",
                    help="road | scalefree | <path.gr>")
    ap.add_argument("--n", type=int, default=1600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--algo", default="hybrid", choices=ALGOS,
                    help="any BuildPlan algorithm (note: 'plant' is "
                         "single-host PLaNT; the distributed driver "
                         "is 'plant-dist')")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--beta", type=float, default=8.0)
    ap.add_argument("--first-superstep", type=int, default=None,
                    dest="first_superstep",
                    help="initial superstep size (roots; grows by beta)")
    ap.add_argument("--eta", type=int, default=16)
    ap.add_argument("--psi-th", type=float, default=None,
                    help="default: auto = gamma*q")
    ap.add_argument("--alpha", type=float, default=None,
                    help="GLL cleaning threshold (labels per vertex)")
    ap.add_argument("--compact", type=int, default=0)
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--store", default="dense",
                    choices=("dense", "sharded", "compressed"),
                    help="label residency of the built index "
                         "(repro_torch.index.store); sharded/compressed "
                         "PLaNT builds stream emissions straight into "
                         "shards")
    ap.add_argument("--shards", type=int, default=None,
                    help="hub partitions for --store sharded/"
                         "compressed (default: mesh size / local "
                         "devices)")
    ap.add_argument("--codec", default=None,
                    choices=("bf16", "u16", "u32"),
                    help="distance codec for --store compressed "
                         "(default bf16)")
    ap.add_argument("--quant-exact", action="store_true",
                    dest="quant_exact",
                    help="demand the validated bit-exact encoding "
                         "(--store compressed; fails rather than "
                         "quantize lossily)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint after every committed superstep "
                         "(every algorithm)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the last committed superstep")
    ap.add_argument("--save-index", default=None,
                    help="finalize into a CHLIndex artifact dir "
                         "(default: <ckpt-dir>/index)")
    ap.add_argument("--queries", type=int, default=0)
    ap.add_argument("--query-mode", default="qlsn",
                    choices=("qlsn", "qfdl", "qdol"))
    ap.add_argument("--device", default=None,
                    help="device to build on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    plan = BuildPlan.from_args(args)
    g, rank = build_graph(args, directed=plan.algo == "directed")

    mesh = None
    q = 1
    if plan.distributed:
        from repro_torch.parallel.mesh import make_node_mesh
        mesh = make_node_mesh(device=dev)
        q = mesh.q
    print(f"graph n={g.n} m={g.m // (1 if g.directed else 2)}; "
          f"q={q} nodes; algo={plan.algo}")

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    idx = build(g, rank, plan, mesh=mesh, device=dev, ckpt=mgr,
                resume=args.resume, verbose=True)
    print(f"CHL done: {idx.report.summary()}")
    if not idx.directed:
        mr = idx.memory_report()
        line = (f"memory: store={mr['store']} shards={mr['shards']} "
                f"label_bytes={mr['label_bytes']} "
                f"({mr['bytes_per_label']:.2f} B/label, "
                f"{mr['compression_ratio']:.2f}x vs dense f32)")
        if "codec" in mr:
            line += (f" codec={mr['codec']}"
                     f"{' exact' if mr['quant_exact'] else ' lossy'}"
                     f" max_ulp_err={mr['max_ulp_err']}")
        print(line)
        if "shard_bytes" in mr:
            print(f"memory: shard_bytes={mr['shard_bytes']}")

    out_dir = args.save_index or (
        os.path.join(args.ckpt_dir, "index") if args.ckpt_dir else None)
    if out_dir:
        idx.save(out_dir)
        print(f"index artifact saved to {out_dir}")

    if args.queries and not idx.directed:
        rng = np.random.default_rng(1)
        srv = idx.serve(mode=args.query_mode, mesh=mesh, batch_size=512)
        srv.warmup(buckets=args.queries % 512 != 0)
        srv.submit(rng.integers(0, g.n, args.queries),
                   rng.integers(0, g.n, args.queries))
        srv.flush()
        print("serving:", srv.stats())
    elif args.queries:
        rng = np.random.default_rng(1)
        d = idx.query(rng.integers(0, g.n, args.queries),
                      rng.integers(0, g.n, args.queries))
        print(f"directed queries: {len(d)} answered, "
              f"{int(np.isfinite(d).sum())} reachable")
    # no "table" key: materializing a dense copy here would defeat a
    # --store sharded build; callers reach labels via index.store (or
    # index.table when they accept the materialization cost)
    return {"als": idx.report.als, "index": idx}


if __name__ == "__main__":
    main()
