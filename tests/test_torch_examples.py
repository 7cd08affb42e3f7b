"""The port's examples (``repro_torch.examples``) on the CPU.

``quickstart``, ``dynamic_repair`` and ``elastic_failover`` run to
their end (each asserts itself: answers against Dijkstra, every store,
repair equal to a rebuild, the recovered labeling equal to PLL's), and
the first two answer as the reference package does on the same graph
(its build, and its repair of the same batch). ``serve_chl_queries``
(the hybrid on 8 logical nodes) takes about four minutes on this CPU,
so ``chip_smoke.py`` runs it on the card; here each example's entry
point refuses to run without CUDA unless a device is named.
"""

import numpy as np
import pytest
import torch

from repro.dynamic import EdgeDelete, EdgeInsert, EdgeReweight, MutationBatch
from repro.graphs import grid_road
from repro.graphs.ranking import betweenness_ranking
from repro.index import BuildPlan, build
from repro_torch.examples import (dynamic_repair, elastic_failover,
                                  quickstart, serve_chl_queries)

torch.set_num_threads(1)


def test_quickstart_runs_and_answers_like_the_reference(capsys):
    out = quickstart.main(device="cpu")
    text = capsys.readouterr().out
    assert "all queries exact — cover property holds" in text
    assert text.count("✓") == 8 and "✗" not in text
    g = grid_road(20, 20, seed=7)
    ref = build(g, betweenness_ranking(g, samples=12),
                BuildPlan(algo="plant", batch=16))
    d, hub = ref.query_with_hub(out["u"], out["v"])
    assert np.array_equal(out["dist"], np.asarray(d))
    assert np.array_equal(out["hub"], np.asarray(hub))


def test_dynamic_repair_runs_and_repairs_like_the_reference(capsys):
    out = dynamic_repair.main(device="cpu")
    text = capsys.readouterr().out
    assert "repair == rebuild, bit for bit ✓" in text
    assert "invalidations=1" in text
    g = grid_road(16, 16, seed=7)
    ref = build(g, betweenness_ranking(g, samples=12),
                BuildPlan(algo="plant", batch=16))
    ref.apply(MutationBatch([EdgeDelete(4, 5), EdgeInsert(0, 2, 14.0),
                             EdgeReweight(9, 25, 20.0)]), graph=g)
    for (_, a), (_, b) in zip(out["index"].store.shard_arrays(),
                              ref.store.shard_arrays()):
        for key in ("hubs", "dist", "count"):
            assert np.array_equal(a[key], np.asarray(b[key])), key
    assert np.array_equal(out["dist"],
                          np.asarray(ref.query(out["u"], out["v"])))


def test_elastic_failover_runs(capsys):
    out = elastic_failover.main(device="cpu")
    text = capsys.readouterr().out
    assert "detected lost=[3]" in text
    assert "recovered labeling == sequential PLL CHL — exact ✓" in text
    assert out["table"].hubs.shape == (300, 128)


@pytest.mark.parametrize("example", [quickstart, dynamic_repair,
                                     elastic_failover, serve_chl_queries],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_refuse_to_run_without_cuda(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main()
