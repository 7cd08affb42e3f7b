"""Compressed label stores in the port, against the reference.

Mirrors the reference's ``test_quant.py`` and holds the port's arrays
against the reference's on the same seeded numpy inputs: the codecs'
codes, scales and ulp errors (byte for byte, the typed refusals too),
the torch decoders against the numpy ones, delta coding (unsorted and
empty rows), every ``CompressedStore`` shard, manifest, answer and
witness hub for bf16/u16/u32, exact and lossy, at K = 1 and K = 2,
routed and unrouted serving, ``build(store="compressed")`` reports,
version-3 compressed artifacts crossing the packages both ways,
re-homing, integrity errors and the ``quant.*`` fault sites. Every
comparison is exact (``np.array_equal``).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import repro.graphs as rg
import repro.index.quant as rq
from repro.graphs.ranking import degree_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import CHLIndex as RefIndex
from repro.index import build as ref_build
from repro.index.store import CompressedStore as RefCompressed
from repro_torch import interop
from repro_torch.ft import Fault, FaultPlan, InjectedCrash, faults
from repro_torch.index import (BuildPlan, CHLIndex, CompressedStore,
                               CorruptArtifactError, DenseStore,
                               QuantizationError, QuantPrecisionError,
                               QuantRangeError, ShardedStore, build)
from repro_torch.index import quant
from repro_torch.index.store import shard_filename

torch.set_num_threads(1)

ENCODED = ("dhub", "dcode", "count")


def small_graph(max_w=10):
    g = rg.scale_free(48, attach=2, seed=3, max_w=max_w)
    return g, degree_ranking(g)


def query_batch(n, count=96, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, count).astype(np.int64),
            rng.integers(0, n, count).astype(np.int64))


def plan_kw(codec, exact, shards):
    return dict(algo="plant", batch=8, store="compressed", codec=codec,
                quant_exact=exact, shards=shards)


def port_error(e):
    """The port's class of a reference quantization error."""
    return {rq.QuantRangeError: QuantRangeError,
            rq.QuantPrecisionError: QuantPrecisionError}[type(e)]


def both_builds(g, rank, **kw):
    return (build(interop.graph(g), rank, BuildPlan(**kw), device="cpu"),
            ref_build(g, rank, RefPlan(**kw)))


def encoded_equal(a, b) -> bool:
    """Shard by shard, the encoded arrays equal in value and dtype."""
    sa, sb = list(a.shard_arrays()), list(b.shard_arrays())
    return len(sa) == len(sb) and all(
        np.asarray(x[k]).dtype == np.asarray(y[k]).dtype
        and np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
        for (_, x), (_, y) in zip(sa, sb) for k in ENCODED)


@pytest.fixture(scope="module")
def graph():
    return small_graph()


@pytest.fixture(scope="module")
def dense_pair(graph):
    g, rank = graph
    return both_builds(g, rank, algo="plant", batch=8)


@pytest.fixture(scope="module")
def u16_pair(graph):
    """(port, reference) u16-exact builds at K = 2."""
    g, rank = graph
    return both_builds(g, rank, **plan_kw("u16", True, 2))


# ------------------------------------------------------------- codecs

def _dist_cases():
    rng = np.random.default_rng(0)
    integral = rng.integers(0, 60_000, (8, 16)).astype(np.float32)
    integral[0, :3] = np.inf
    wide = (rng.random((8, 16)) * 1e6).astype(np.float32)
    wide[1, 1] = np.inf
    big = rng.integers(0, 1 << 30, (4, 8)).astype(np.float32)
    return {"integral": integral, "wide": wide, "big": big,
            "empty": np.full((3, 2), np.inf, np.float32),
            "fraction": np.array([[1.5, 0.0, np.inf]], np.float32),
            "bf16-ok": np.array([[0.0, 1.0, 2.5, 100.0, np.inf]],
                                np.float32)}


@pytest.mark.parametrize("case", sorted(_dist_cases()))
@pytest.mark.parametrize("codec", quant.DIST_CODECS)
@pytest.mark.parametrize("exact", [False, True])
def test_encode_dist_equals_reference(case, codec, exact):
    """Codes, scale and max ulp byte for byte, or the same typed
    refusal."""
    d = _dist_cases()[case]
    try:
        want = rq.encode_dist(d, codec, exact=exact)
    except rq.QuantizationError as e:
        with pytest.raises(port_error(e), match=re.escape(str(e))):
            quant.encode_dist(d, codec, exact=exact)
        return
    codes, scale, ulp = quant.encode_dist(d, codec, exact=exact)
    assert codes.dtype == want[0].dtype
    assert np.array_equal(codes, want[0])
    assert scale == want[1] and ulp == want[2]
    dec = quant.decode_dist_np(codes, codec, scale)
    assert np.array_equal(dec, rq.decode_dist_np(codes, codec, scale))
    # the device decoder equals the host one bit for bit
    got = quant.decode_dist_torch(quant.code_tensor(codes, "cpu"), codec,
                                  scale).numpy()
    assert np.array_equal(got.view(np.int32), dec.view(np.int32))


def test_exact_refusals_and_unknown_codec():
    over = np.array([[70000.0]], np.float32)      # > u16 max - 1
    with pytest.raises(QuantRangeError, match="diameter"):
        quant.encode_dist(over, "u16", exact=True)
    codes, scale, _ = quant.encode_dist(over, "u32", exact=True)
    assert np.array_equal(quant.decode_dist_np(codes, "u32", scale), over)
    with pytest.raises(QuantPrecisionError, match="integral"):
        quant.encode_dist(np.array([[1.5]], np.float32), "u16", exact=True)
    with pytest.raises(QuantPrecisionError, match="bf16"):
        quant.encode_dist(np.array([[1.0009765625]], np.float32), "bf16",
                          exact=True)
    with pytest.raises(QuantizationError):
        quant.encode_dist(over, "nope")


def test_u32_decode_rounds_codes_past_2_24_like_numpy():
    """numpy's u32 -> f32 conversion rounds to nearest even; the torch
    decode must too, for lossy codes above 2^24 (and the max code)."""
    codes = np.array([[(1 << 24) + 1, (1 << 24) + 3, (1 << 25) + 2,
                       (1 << 31) + 12345, 0xFFFFFFFE, 0xFFFFFFFF]],
                     np.uint32)
    for scale in (1.0, float(np.float32(6.86e6 / 0xFFFFFFFE)),
                  float(np.float32(1e-3))):
        want = rq.decode_dist_np(codes, "u32", scale)
        got = quant.decode_dist_torch(quant.code_tensor(codes, "cpu"),
                                      "u32", scale).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isinf(want[0, -1])


def test_code_tensors_keep_storage_bits():
    for dt in (np.uint8, np.uint16, np.uint32):
        a = np.array([[0, 1, np.iinfo(dt).max - 1, np.iinfo(dt).max]], dt)
        t = quant.code_tensor(a, "cpu")
        back = quant.code_array(t, dt)
        assert back.dtype == a.dtype and np.array_equal(back, a)
        assert np.array_equal(quant.widen_codes(t).numpy(),
                              a.astype(np.int64))


def test_max_ulp_error_equals_reference():
    d = _dist_cases()["wide"]
    for codec in quant.DIST_CODECS:
        codes, scale, _ = quant.encode_dist(d, codec)
        dec = quant.decode_dist_np(codes, codec, scale)
        assert quant.max_ulp_error(d, dec) == rq.max_ulp_error(d, dec)


# ------------------------------------------------------------- deltas

def _delta_case(n, Ls, seed):
    """Rows of distinct hubs in random (not order-sorted) slot order,
    random counts, row 0 empty."""
    rng = np.random.default_rng(seed)
    rank = rng.permutation(n).astype(np.int64)
    count = rng.integers(0, Ls + 1, n).astype(np.int32)
    count[0] = 0                                   # an empty row
    hubs = ((rng.integers(0, n, n)[:, None]
             + np.arange(Ls)[None, :] * (n // Ls)) % n).astype(np.int32)
    hubs = np.take_along_axis(hubs, np.argsort(rng.random((n, Ls)), axis=1),
                              axis=1)
    dist = rng.integers(1, 50, (n, Ls)).astype(np.float32)
    pad = np.arange(Ls)[None, :] >= count[:, None]
    hubs[pad] = -1
    dist[pad] = np.inf
    return rank, hubs, dist, count


@pytest.mark.parametrize("n,Ls", [(32, 6), (300, 4), (70_000, 2)])
def test_delta_coding_equals_reference(n, Ls):
    """Encoded deltas (u8, u16 and u32 widths), sorted distances and both
    decoders equal the reference's; unsorted and empty rows included."""
    rank, hubs, dist, count = _delta_case(n, Ls, seed=n)
    order, oi = quant.order_permutation(rank)
    r_order, r_oi = rq.order_permutation(rank)
    assert np.array_equal(order, r_order) and np.array_equal(oi, r_oi)
    assert order.dtype == r_order.dtype
    deltas, dist_s, cnt = quant.delta_encode_rows(hubs, dist, count, oi)
    want = rq.delta_encode_rows(hubs, dist, count, r_oi)
    for got, ref in zip((deltas, dist_s, cnt), want):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    back = quant.delta_decode_rows_np(deltas, cnt, order)
    assert np.array_equal(back, rq.delta_decode_rows_np(deltas, cnt, order))
    dev = quant.delta_decode_rows_torch(quant.code_tensor(deltas, "cpu"),
                                        torch.from_numpy(cnt),
                                        torch.from_numpy(order))
    assert dev.dtype == torch.int32 and np.array_equal(dev.numpy(), back)
    assert (back[0] == -1).all()
    assert str(deltas.dtype) == {32: "uint8", 300: "uint16",
                                 70_000: "uint32"}[n]
    for i in range(min(n, 64)):
        assert {(h, d) for h, d in zip(back[i], dist_s[i]) if h >= 0} == \
            {(h, d) for h, d in zip(hubs[i], dist[i]) if h >= 0}


# ------------------------------------------------------------- stores

@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("codec,exact", [("bf16", False), ("bf16", True),
                                         ("u16", False), ("u16", True),
                                         ("u32", False), ("u32", True)])
def test_compressed_build_equals_reference(graph, codec, exact, shards):
    """Encoded shards (values and dtypes), the manifest's codec fields,
    the report's quant note and every (dist, hub) answer equal the
    reference's, or both refuse with the same typed error."""
    g, rank = graph
    kw = plan_kw(codec, exact, shards)
    try:
        ref = ref_build(g, rank, RefPlan(**kw))
    except rq.QuantizationError as e:
        with pytest.raises(port_error(e), match=re.escape(str(e))):
            build(interop.graph(g), rank, BuildPlan(**kw), device="cpu")
        return
    port = build(interop.graph(g), rank, BuildPlan(**kw), device="cpu")
    assert isinstance(port.store, CompressedStore)
    assert encoded_equal(port.store, ref.store)
    assert port.store.manifest_info() == ref.store.manifest_info()
    assert port.store.label_bytes() == ref.store.label_bytes()
    assert port.store.shard_label_bytes() == ref.store.shard_label_bytes()
    assert port.report.notes == ref.report.notes
    u, v = query_batch(g.n)
    d, h = port.query_with_hub(u, v)
    rd, rh = ref.query_with_hub(u.astype(np.int32), v.astype(np.int32))
    assert np.array_equal(d, rd) and np.array_equal(h, rh)
    for k in range(shards):
        pd, ph = port.store.query_shard(k, u, v)
        qd, qh = ref.store.query_shard(k, u.astype(np.int32),
                                       v.astype(np.int32))
        assert np.array_equal(pd, qd) and np.array_equal(ph, qh)
    # the decoded view equals the reference's, shard by shard
    for (_, a), (_, b) in zip(port.store.decoded_shard_arrays(),
                              ref.store.decoded_shard_arrays()):
        for key in ("hubs", "dist", "count"):
            assert np.array_equal(a[key], b[key])


def test_compressed_exact_answers_equal_dense(dense_pair, u16_pair, graph):
    g, _ = graph
    dense, _ = dense_pair
    comp, _ = u16_pair
    u, v = query_batch(g.n)
    d, h = comp.query_with_hub(u, v)
    assert np.array_equal(d, dense.query(u, v))
    finite = np.isfinite(d)
    assert (h[finite] >= 0).all() and (h[~finite] == -1).all()
    assert comp.store.label_bytes() == comp.total_labels * 3


@pytest.mark.parametrize("routed", [None, True, False])
def test_compressed_serve_routed_and_unrouted_equal_reference(
        u16_pair, graph, routed):
    g, _ = graph
    port, ref = u16_pair
    u, v = query_batch(g.n)
    srv = port.serve(mode="qlsn", batch_size=len(u), routed=routed)
    srv.submit(u, v)
    rsrv = ref.serve(mode="qlsn", batch_size=len(u), routed=routed)
    rsrv.submit(u.astype(np.int32), v.astype(np.int32))
    assert np.array_equal(srv.flush(), np.asarray(rsrv.flush()))


def test_build_report_and_manifest_equal_reference(u16_pair, tmp_path):
    port, ref = u16_pair
    pm = _manifest(port.save(str(tmp_path / "port")))
    rm = _manifest(ref.save(str(tmp_path / "ref")))
    for m in (pm, rm):
        m["report"].pop("wall_s")
        m["store"].pop("shard_sha256")
    assert pm == rm
    assert pm["store"]["kind"] == "compressed"
    assert pm["store"]["dtype"]["dcode"] == "uint16"


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_compressed_artifacts_cross_packages(u16_pair, graph, tmp_path,
                                             direction):
    """A compressed artifact saved by either package loads in the other
    with equal encoded shards and answers."""
    g, rank = graph
    port, ref = u16_pair
    u, v = query_batch(g.n)
    if direction == "port->ref":
        loaded = RefIndex.load(port.save(str(tmp_path / "a")), rank=rank)
        assert isinstance(loaded.store, RefCompressed)
        assert encoded_equal(loaded.store, port.store)
        got = loaded.query(u.astype(np.int32), v.astype(np.int32))
    else:
        loaded = CHLIndex.load(ref.save(str(tmp_path / "a")), rank=rank,
                               device="cpu")
        assert isinstance(loaded.store, CompressedStore)
        assert encoded_equal(loaded.store, ref.store)
        assert loaded.store.manifest_info() == ref.store.manifest_info()
        got = loaded.query(u, v)
    assert np.array_equal(got, port.query(u, v))


def test_interop_rebuilds_a_reference_compressed_store(u16_pair, graph):
    g, rank = graph
    port, ref = u16_pair
    store = interop.compressed_store(ref.store, rank, device="cpu")
    assert encoded_equal(store, ref.store)
    u, v = query_batch(g.n)
    for a, b in zip(store.query(u, v), port.store.query(u, v)):
        assert np.array_equal(a, b)


def test_load_rehomes_compressed_both_directions(dense_pair, u16_pair,
                                                 graph, tmp_path):
    g, rank = graph
    dense, rdense = dense_pair
    comp, _ = u16_pair
    u, v = query_batch(g.n)
    want = dense.query(u, v)
    dpath = dense.save(str(tmp_path / "dense"))
    as_comp = CHLIndex.load(dpath, store="compressed", codec="u16",
                            quant_exact=True, device="cpu")
    ref_comp = RefIndex.load(dpath, store="compressed", codec="u16",
                             quant_exact=True)
    assert isinstance(as_comp.store, CompressedStore)
    assert encoded_equal(as_comp.store, ref_comp.store)
    assert np.array_equal(as_comp.query(u, v), want)
    cpath = comp.save(str(tmp_path / "comp"))
    for kind, cls in (("dense", DenseStore), ("sharded", ShardedStore)):
        back = CHLIndex.load(cpath, store=kind, device="cpu")
        assert isinstance(back.store, cls), kind
        assert np.array_equal(back.query(u, v), want)
    re = CHLIndex.load(cpath, store="compressed", codec="bf16",
                       device="cpu")
    ref_re = RefIndex.load(cpath, store="compressed", codec="bf16")
    assert re.store.codec == "bf16" and encoded_equal(re.store,
                                                      ref_re.store)
    same = CHLIndex.load(cpath, store="compressed", device="cpu")
    assert same.store.codec == "u16"
    assert np.array_equal(same.query(u, v), want)
    # the decoded label sets equal the dense build's
    from repro_torch.core import labels as lbl
    assert lbl.to_numpy_sets(same.table) == lbl.to_numpy_sets(dense.table)


def test_spill_of_a_compressed_artifact_refused(u16_pair, tmp_path):
    port, _ = u16_pair
    path = port.save(str(tmp_path / "idx"))
    with pytest.raises(ValueError, match="memory-mapped"):
        CHLIndex.load(path, store="spill", device="cpu")


# ------------------------------------------- integrity + fault sites

def test_tampered_encoded_shard_raises_corrupt(u16_pair, tmp_path):
    port, _ = u16_pair
    path = port.save(str(tmp_path / "idx"))
    fpath = os.path.join(path, shard_filename(0))
    blob = bytearray(open(fpath, "rb").read())
    blob[len(blob) // 2] ^= 0x10
    with open(fpath, "wb") as f:
        f.write(blob)
    with pytest.raises(CorruptArtifactError, match="sha256"):
        CHLIndex.load(path, device="cpu")


def test_structurally_corrupt_encoded_shard_raises_typed(graph):
    g, rank = graph
    idx = build(interop.graph(g), rank,
                BuildPlan(**plan_kw("u16", True, 1)), device="cpu")
    (s,) = [dict(a) for _, a in idx.store.shard_arrays()]
    info = idx.store.manifest_info()
    bad = dict(s, dhub=s["dhub"].copy())
    bad["dhub"][0, 0] = np.iinfo(bad["dhub"].dtype).max   # oi >= n
    with pytest.raises(CorruptArtifactError, match="order index"):
        CompressedStore.from_encoded_shards([bad], info, rank,
                                            device="cpu")
    with pytest.raises(ValueError, match="order index"):
        RefCompressed.from_encoded_shards([bad], info, rank)
    bad2 = dict(s, count=s["count"].copy())
    bad2["count"][0] = s["dhub"].shape[1] + 7
    with pytest.raises(CorruptArtifactError, match="counts"):
        CompressedStore.from_encoded_shards([bad2], info, rank,
                                            device="cpu")
    bad3 = dict(s, dcode=s["dcode"][:, :-1])
    with pytest.raises(CorruptArtifactError, match="shapes"):
        CompressedStore.from_encoded_shards([bad3], info, rank,
                                            device="cpu")


def test_fault_sites_quant_encode_and_decode(dense_pair, u16_pair, graph,
                                             tmp_path):
    g, _ = graph
    dense, _ = dense_pair
    port, _ = u16_pair
    path = port.save(str(tmp_path / "idx"))
    with faults(FaultPlan({"quant.encode.shard": [Fault("crash")]})):
        with pytest.raises(InjectedCrash):
            CHLIndex.load(path, store="compressed", codec="bf16",
                          device="cpu")
    with faults(FaultPlan({"quant.decode.shard": [Fault("crash")]})):
        with pytest.raises(InjectedCrash):
            CHLIndex.load(path, device="cpu")
    u, v = query_batch(g.n)
    assert np.array_equal(CHLIndex.load(path, device="cpu").query(u, v),
                          dense.query(u, v))


def test_memory_report_compressed_equals_reference(u16_pair):
    port, ref = u16_pair
    got, want = port.memory_report(q=4), ref.memory_report(q=4)
    assert got == want
    assert got["codec"] == "u16" and got["quant_exact"]
    assert got["bytes_per_label"] == pytest.approx(3.0)


def test_build_exact_overflow_refused_typed():
    """Distances past u16's range refuse u16-exact in both packages and
    encode exactly under u32."""
    g, rank = small_graph(max_w=60000)
    with pytest.raises(QuantRangeError, match="u16"):
        build(interop.graph(g), rank,
              BuildPlan(**plan_kw("u16", True, 1)), device="cpu")
    port, ref = both_builds(g, rank, **plan_kw("u32", True, 1))
    dense = build(interop.graph(g), rank, BuildPlan(algo="plant", batch=8),
                  device="cpu")
    u, v = query_batch(g.n)
    assert encoded_equal(port.store, ref.store)
    assert np.array_equal(port.query(u, v), dense.query(u, v))


def test_directed_build_rejects_compressed_store():
    gd = interop.graph(rg.random_connected(16, extra_edges=12, seed=0,
                                           directed=True))
    with pytest.raises(ValueError, match="dense"):
        build(gd, degree_ranking(gd),
              BuildPlan(algo="directed", store="compressed"), device="cpu")


@pytest.mark.parametrize("algo", ["gll", "pll-ref"])
def test_compressed_build_of_other_algos_equals_reference(graph, algo):
    """pll-ref streams like PLaNT; gll builds dense and encodes the
    table."""
    g, rank = graph
    kw = dict(plan_kw("u32", True, 2), algo=algo)
    port, ref = both_builds(g, rank, **kw)
    assert encoded_equal(port.store, ref.store)
    assert port.report.notes == ref.report.notes
