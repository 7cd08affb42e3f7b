"""Query-serving launcher over a saved ``CHLIndex`` artifact.

    python -m repro_torch.launch.serve_chl --index run/index \
        --store compressed --codec u32 --quant-exact \
        --batch-size 512 --arrival-qps 2000 --batch-deadline-ms 2

Loads a versioned artifact (written by either package's
``CHLIndex.save``) onto ``--device`` (default: the card; it raises
without CUDA) and drives the serving tier
(:class:`repro_torch.serve.QueryService`). The port serves the qlsn
storage mode; ``--mode qfdl``/``qdol`` raise until the distributed port
lands. ``--store`` overrides the label residency: ``sharded`` re-homes
the labels into hub partitions (``--shards`` picks K), ``spill``
memory-maps the shard files so an index larger than host RAM still
serves, ``compressed`` quantizes the labels (``--codec`` picks the
distance codec) so 2–4x more labels stay resident on the card.

Two drive shapes:

- default (``--arrival-qps 0``): submit the whole workload and flush —
  the synchronous batch benchmark;
- ``--arrival-qps > 0``: open-loop Poisson arrivals in real time
  through the micro-batcher (``--batch-deadline-ms`` bounds how long a
  tail waits, ``--cache`` sizes the hot-pair LRU, ``--max-queue``
  bounds admission — overload is rejected, not buffered).
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from repro_torch.index import CHLIndex


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True,
                    help="CHLIndex artifact directory")
    ap.add_argument("--mode", default="qlsn",
                    choices=("qlsn", "qfdl", "qdol"))
    ap.add_argument("--store", default=None,
                    choices=("dense", "sharded", "spill", "compressed"),
                    help="label residency override "
                         "(default: the artifact's own layout)")
    ap.add_argument("--shards", type=int, default=None,
                    help="hub partitions when re-homing to "
                         "sharded/compressed")
    ap.add_argument("--codec", default=None,
                    choices=("bf16", "u16", "u32"),
                    help="distance codec when re-homing to compressed "
                         "(default: bf16, or the artifact's own)")
    ap.add_argument("--quant-exact", action="store_true",
                    dest="quant_exact",
                    help="demand the validated bit-exact encoding when "
                         "re-homing to compressed")
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival-qps", type=float, default=0.0,
                    help="open-loop Poisson arrival rate "
                         "(0 = synchronous batch drive)")
    ap.add_argument("--batch-deadline-ms", type=float, default=2.0,
                    help="max wait before a partial batch is forced out")
    ap.add_argument("--cache", type=int, default=0,
                    help="hot-pair LRU answer-cache entries (0 = off)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-queue bound (overload rejects)")
    ap.add_argument("--no-routing", action="store_true",
                    help="disable per-shard query routing (full "
                         "K-shard reduction)")
    ap.add_argument("--zipf", type=float, default=0.0,
                    help="Zipf exponent for skewed endpoints "
                         "(0 = uniform)")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    idx = CHLIndex.load(args.index, store=args.store,
                        shards=args.shards, codec=args.codec,
                        quant_exact=args.quant_exact, device=args.device)
    print(f"loaded index: n={idx.n} labels={idx.total_labels} "
          f"ALS={idx.als:.1f} built-by={idx.plan.algo} "
          f"store={idx.store.kind}/{idx.store.num_shards}")
    print("memory:", idx.memory_report())

    svc = idx.serve(mode=args.mode, batch_size=args.batch_size,
                    deadline_ms=args.batch_deadline_ms,
                    cache=args.cache, max_queue=args.max_queue,
                    routed=False if args.no_routing else None)

    rng = np.random.default_rng(args.seed)
    if args.zipf > 0:
        from repro_torch.serve import zipf_pairs
        u, v = zipf_pairs(idx.n, args.queries, rng, a=args.zipf)
    else:
        u = rng.integers(0, idx.n, args.queries).astype(np.int32)
        v = rng.integers(0, idx.n, args.queries).astype(np.int32)

    if args.arrival_qps > 0:
        from repro_torch.serve import poisson_open_loop
        stats = poisson_open_loop(svc, u, v, args.arrival_qps, rng=rng)
        out = svc.flush()          # collect epoch values (order kept)
        rej = stats["rejected"]
        hit = stats["cache_hit_rate"]
        print(f"{args.mode} open-loop @ {args.arrival_qps:,.0f} q/s "
              f"offered: {stats['queries']} answered, {rej} rejected, "
              f"{stats['batches']} batches "
              f"(occupancy {stats['batch_occupancy']:.2f})")
        print(f"  capacity {stats['capacity_qps']:,.0f} q/s, cache hit "
              f"{0.0 if math.isnan(hit) else hit:.2f}, "
              f"total p50={stats['total_p50_ms']:.2f} ms "
              f"p99={stats['total_p99_ms']:.2f} ms "
              f"(queue p99={stats['queue_p99_ms']:.2f} ms)")
    else:
        # a workload that doesn't fill the last batch launches a
        # bucketed partial — run those shapes once too, so the
        # percentiles never swallow a first launch
        warm = svc.warmup(buckets=args.queries % args.batch_size != 0)
        print(f"warmup (first launches): {warm*1e3:.1f} ms")
        svc.submit(u, v)
        out = svc.flush()
        stats = svc.stats()
        print(f"{args.mode}: {stats['queries']} queries in "
              f"{stats['batches']} batches — "
              f"{stats['throughput_qps']:,.0f} q/s, "
              f"p50={stats['p50_ms']:.2f} ms "
              f"p99={stats['p99_ms']:.2f} ms")
    return {"distances": out, "stats": stats, "index": idx,
            "service": svc}


if __name__ == "__main__":
    main()
