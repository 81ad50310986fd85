"""The metric arithmetic: rates over the whole window, the tail over every
increment, the byte counts from shapes, the busy share over overlapping
intervals."""

import numpy as np
import pytest

from portbench import core, roofline, trace
from portbench.core import Cell


def reader(name):
    return Cell("plate.fused-plastic").reader(name)


def window(seconds=0.0, spans=None, **counts):
    w = core.Window()
    w.seconds = seconds
    w.counts.update(counts)
    for k, v in (spans or {}).items():
        w.spans[k] = list(v)
    return w


def record(timed=None, traced=None, shapes=None):
    rec = core.Record()
    rec.timed, rec.traced, rec.shapes = timed, traced, shapes or {}
    return rec


def test_rates_take_the_whole_window():
    rec = record(window(4.0, point_updates=3 * 2**21, converged=8))
    assert reader("gp_updates_per_s").read(rec) == pytest.approx(3 * 2**21 / 4.0)
    assert reader("load_step_s").read(rec) == pytest.approx(0.5)
    assert reader("load_step_s").read(record(window(4.0, converged=0))) is None


def test_p95_is_over_every_increment():
    lat = np.random.default_rng(0).permutation(np.arange(1, 1001)) * 1e-3
    rec = record(window(1.0, {"increment": lat}))
    assert reader("update_p95_ms").read(rec) == pytest.approx(np.percentile(np.arange(1, 1001), 95))


def test_counts_per_step_and_cg_iteration_time():
    rec = record(window(10.0, {"cg_solve": [0.2, 0.3]}, attempted=4, newton=14, cg=2000))
    assert reader("newton_per_step.plate").read(rec) == 3.5
    assert reader("cg_per_step.plate").read(rec) == 500
    assert reader("cg_iter_ms.plate").read(rec) == pytest.approx(0.25)
    assert reader("host_us_per_update.points").read(record(window(1.0, {"host": [1e-5, 3e-5]}))) == pytest.approx(20)


PLATE = dict(ne=32768, ndof_el=18, ndofs=263682, nnodes=131841, ncomp=2, nmodes=2, ncoarse=968, dtype="float64")


def test_cg_iteration_bytes_of_the_plate():
    elements = 32768 * 18 * 18 * 8
    vectors = 7 * 263682 * 8
    coarse = 968 * 968 * 8 + 131841 * 2 * 2 * 8 + 131841 * 8
    assert roofline.cg_iteration_bytes(**PLATE) == elements + vectors + coarse == 112_470_680
    s = roofline.least_seconds(roofline.cg_iteration_bytes(**PLATE), 0, "float64")
    assert s == pytest.approx(112_470_680 / 3.35e12)


def test_j2_update_bytes_and_bound():
    n = 2**21
    assert roofline.j2_update_bytes(n, "float64") == 62 * 8 * n == 1_040_187_392
    assert roofline.j2_update_ops(1) == 45 + 10 * 14 + 8 * 12 + 30 + 15 + 144
    # bytes-bound: 0.31 ms against 0.03 ms of operations
    least = roofline.least_seconds(roofline.j2_update_bytes(n, "float64"), roofline.j2_update_ops(n), "float64")
    assert least == pytest.approx(1_040_187_392 / 3.35e12)


def test_busy_share_over_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8)]
    busy = trace.merged(iv)
    assert sum(b - a for a, b in busy) == 4
    assert [list(b) for b in busy] == [[0, 3], [5, 6], [8, 8]]
    assert trace.clipped_seconds(busy, [(2, 5.5), (2.5, 2.8)]) == pytest.approx(1.5)


def test_roofline_and_idle_readers_read_the_trace():
    t = trace.Summary(window_s=2.0, busy_s=1.5, host_clipped={"cg_solve": 1e-3}, device_clipped={"update": 4e-3})
    rec = record(traced=window(2.0, {"increment": [1.0] * 10}, cg=10), shapes=PLATE)
    rec.traced.trace = t
    assert reader("device_idle_pct.plate").read(rec) == pytest.approx(25.0)
    assert reader("cg_iter_roofline_pct.plate").read(rec) == pytest.approx(100 * 10 * 112_470_680 / 3.35e12 / 1e-3)
    rec.shapes = dict(n_points=2**21, dtype="float64", law=None)
    assert reader("k1_roofline_pct.points").read(rec) == pytest.approx(100 * 10 * 1_040_187_392 / 3.35e12 / 4e-3)
    t.busy_s = 0.0
    assert reader("device_idle_pct.points").read(rec) is None


def test_idle_gaps_go_to_the_innermost_host_event():
    cpu = [("outer", 0, 100, 1), ("inner", 10, 20, 1), ("other", 30, 40, 1), ("elsewhere", 0, 5, 2)]
    gaps = [(12, 14), (25, 27), (35, 36), (150, 160)]
    assert trace._gap_owners(gaps, cpu) == ["inner", "outer", "other", "python"]


def test_sessions_add_up():
    a = trace.Summary(1.0, 0.5, {"cg_solve": 0.2}, {"cg_solve": None}, {"k": 0.3, "c": 0.1}, {"python": 0.2})
    a.add(trace.Summary(2.0, 1.5, {"cg_solve": 0.4}, {"cg_solve": 0.1}, {"k": 0.6}, {"python": 0.15, "sync": 0.3}))
    assert (a.window_s, a.busy_s) == (3.0, 2.0)
    assert a.host_clipped == {"cg_solve": pytest.approx(0.6)} and a.device_clipped == {"cg_solve": 0.1}
    assert a.top(a.ops) == [["k", pytest.approx(0.9)], ["c", 0.1]]
    assert a.top(a.gaps) == [["python", pytest.approx(0.35)], ["sync", 0.3]]
