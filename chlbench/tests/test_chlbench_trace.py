"""The trace's reduction to busy time, idle share and breakdown, on a
device trace written by hand (no card needed)."""

import pytest

from chlbench import trace


def hand_trace():
    t = trace.DeviceTrace()
    t.offset_ns = 1000             # device clock = host clock + 1000 ns
    # device ns: two overlapping kernels, a gap, a copy, a gap to the end
    t.events = [("void relax_tiles_kernel<4>(float*)", 1100, 1400),
                ("void relax_tiles_kernel<4>(float*)", 1300, 1500),
                ("Memcpy DtoH", 1700, 1800),
                ("plant_step", 1000, 2000)]       # a span's own range
    spans = trace.Spans()
    spans.items = [("window", 0, 1000), ("plant_step", 50, 600),
                   ("new_sink", 650, 700)]
    return t, spans


def test_busy_union_idle_and_breakdown():
    t, spans = hand_trace()
    got = trace.summarize(t, spans, (0, 1000))
    # busy: [1100, 1500] and [1700, 1800] = 500 ns of a 1000 ns window
    assert got["busy_s"] == pytest.approx(500e-9)
    assert got["window_s"] == pytest.approx(1000e-9)
    ops = dict(got["breakdown"]["device_ops"])
    assert ops == {"relax_tiles_kernel<4>(float*)": pytest.approx(500e-9),
                   "Memcpy DtoH": pytest.approx(100e-9)}
    gaps = dict(got["breakdown"]["idle_gaps"])
    # host times of the gaps: [0, 100) window; [500, 700) plant_step;
    # [800, 1000) window
    assert gaps == {"window": pytest.approx(300e-9),
                    "plant_step": pytest.approx(200e-9)}


def test_no_device_events_reads_nothing():
    t, spans = hand_trace()
    t.events = []
    assert trace.summarize(t, spans, (0, 1000)) is None
    t, spans = hand_trace()
    t.offset_ns = None
    assert trace.summarize(t, spans, (0, 1000)) is None


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (1, 3), (2, 4), (7, 9)]) == [(1, 4), (5, 9)]
