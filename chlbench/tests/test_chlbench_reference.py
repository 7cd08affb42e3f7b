"""The plain reference against brute force, and its control.

Brute force: all-pairs distances by Floyd-Warshall, and a label (h, v)
wherever no vertex of higher rank than h lies on any shortest h-v path,
looked for among all vertices (the reference looks only among the
roots, which is the same when the roots top the rank order).
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chlbench import bench, check
from chlbench.reference import canonical_labels as ref

REF_DIR = Path(ref.__file__).resolve().parent


def random_graph(n, m, seed, max_w=9):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    # a repeated pair with another weight, and a self loop
    src = np.concatenate([src, src[:1], [3]]).astype(np.int32)
    dst = np.concatenate([dst, dst[:1], [3]]).astype(np.int32)
    w = rng.integers(1, max_w, len(src)).astype(np.float32)
    rank = rng.permutation(n).astype(np.int32)
    return src, dst, w, rank


def brute_table(n, src, dst, w, rank, trees, cap):
    d = np.full((n, n), np.inf)
    np.fill_diagonal(d, 0)
    for a, b, x in zip(src, dst, w):
        if a != b:
            d[a, b] = d[b, a] = min(d[a, b], float(x))
    for k in range(n):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    roots = np.argsort(-rank.astype(np.int64), kind="stable")[:trees]
    hubs = np.full((n, cap), -1, np.int32)
    dist = np.full((n, cap), np.inf, np.float32)
    count = np.zeros(n, np.int32)
    for h in roots:
        higher = np.nonzero(rank > rank[h])[0]
        for v in range(n):
            if not np.isfinite(d[h, v]):
                continue
            if any(d[h, x] + d[x, v] == d[h, v] for x in higher):
                continue
            if count[v] < cap:
                hubs[v, count[v]], dist[v, count[v]] = h, d[h, v]
            count[v] += 1
    return hubs, dist, np.minimum(count, cap)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n, m", [(30, 45), (40, 30)])   # sparse: parts
def test_reference_equals_brute_force(n, m, seed):
    src, dst, w, rank = random_graph(n, m, seed)
    trees, cap = 6, 4
    r = ref.Reference(n, src, dst, w, rank, trees=trees, cap=cap,
                      device="cpu")
    for k in (2, trees):
        got = r.table(k)
        want = brute_table(n, src, dst, w, rank, k, cap)
        assert np.array_equal(got.hubs.numpy(), want[0])
        assert np.array_equal(got.dist.numpy(), want[1])
        assert np.array_equal(got.count.numpy(), want[2])


def test_reference_chunks_a_round_like_one_pass(monkeypatch):
    src, dst, w, rank = random_graph(50, 200, 7)
    whole = ref.Reference(50, src, dst, w, rank, trees=5, cap=8,
                          device="cpu").table(5)
    monkeypatch.setattr(ref, "CHUNK_EDGES", 3)
    cut = ref.Reference(50, src, dst, w, rank, trees=5, cap=8,
                        device="cpu").table(5)
    assert all(torch.equal(a, b) for a, b in zip(whole, cut))


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in sorted(REF_DIR.rglob("*.py")):
        tree = ast.parse(path.read_text())
        names = [a.name for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for a in node.names]
        names += [node.module or "" for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom)]
        tops = {x.split(".")[0] for x in names}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                           "chlbench"}, (path, tops)


# urand with few edges a vertex: distances pass 256, where bfloat16 stops
# holding integers (at its cell's size they reach ~10^3)
@pytest.mark.parametrize("scale, edge_factor", [(14, 2), (12, 1)])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_in_bfloat16_fails_the_check(tiny_root, scale, edge_factor,
                                             seed):
    """The control: the reference in the precision below the
    configuration's float32, put in the program's place, is caught by
    the row comparison (the last cycle and a partial one)."""
    cfg = json.loads((tiny_root / "chlbench/configs/chl_urand22.json")
                     .read_text())
    cfg.update(scale=scale, n=1 << scale, edge_factor=edge_factor)
    gen = bench.load_module(tiny_root / f"chlbench/graphs/"
                            f"{cfg['generator']}.py")
    n, src, dst, w = gen.edges(cfg, np.random.default_rng(seed))
    rank = bench.load_module(tiny_root / "chlbench/rankings/degree.py"
                             ).rank(n, src, dst)
    mix = json.loads((tiny_root / "chlbench/traffic/plant-top8.json")
                     .read_text())
    k = mix["trees"]
    kw = dict(trees=k, cap=cfg["cap"], device="cpu")
    exact = ref.Reference(n, src, dst, w, rank, **kw)
    control = ref.Reference(n, src, dst, w, rank, dtype=torch.bfloat16,
                            **kw)
    for kk in (k, cfg["batch"]):
        bad = check.count_rows_differing(control.table(kk), exact.table(kk))
        assert bad > 0
        assert not check.within({"full_rows_differing": {"value": bad,
                                                         "limit": 0}})


def test_control_script_reads_the_control_as_not_correct(tiny_root):
    from chlbench import control
    path = tiny_root / "chlbench/configs/chl_urand22.json"
    cfg = json.loads(path.read_text())
    cfg.update(scale=14, n=1 << 14, edge_factor=2)  # distances past 256
    path.write_text(json.dumps(cfg))
    got = control.readings(tiny_root, "urand-plant", 7, "cpu")
    assert got["correct"] is False
    assert got["checks"]["full_rows_differing"]["value"] > 0
