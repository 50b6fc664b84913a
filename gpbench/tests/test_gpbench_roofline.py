"""The frozen counts against shapes worked by hand, and the trace
reduction on a made-up trace."""

import math

import pytest

from gpbench import harness, readers, roofline


def test_cg_solve_bound_by_hand():
    rows, m, steps = 2059, 989, 331
    bound_ms, what, part, parts = roofline.cg_solve_bound(rows, m, steps)
    tc = steps * 2.0 * rows * m * m
    fma = tc + steps * 11.0 * rows * m
    by_hand = (3.0 * tc / 495e12 + (fma - tc) / 67e12) * 1e3
    assert part == "3xTF32 tensor cores" and what == "operations"
    assert bound_ms == pytest.approx(by_hand, rel=1e-12)
    assert parts["bytes"] == pytest.approx(4.0 * (m * m + 2 * rows * m) / 3.35e12 * 1e3)


def test_gram_bound_matches_the_kernel_tables_figure():
    # One B3 product at R = 2059, M = 10240: ~2.63 ms, set by the tensor cores.
    bound_ms, what, part, _ = roofline.gram_bound(10240, 10240, 3, 2059)
    by_hand = (3.0 * 2.0 * 10240 ** 2 * 2059 / 495e12 + 2.0 * 10240 ** 2 * 3 / 67e12) * 1e3
    assert bound_ms == pytest.approx(by_hand, rel=1e-12)
    assert bound_ms == pytest.approx(2.63, abs=0.01) and part == "3xTF32 tensor cores"


def test_small_r_is_bound_by_bytes():
    bound_ms, what, _, parts = roofline.cg_solve_bound(1, 32768, 1)
    assert what == "bytes" and bound_ms == parts["bytes"]


def _ctx(trace, solves, counts, shapes, spans=None):
    return harness.MetricContext(trace=trace, spans=spans or {}, solves=solves,
                                 counts=counts, shapes=shapes, values={})


def test_readers_on_made_up_numbers():
    trace = harness.TraceReading(busy_s=0.9, window_s=1.0,
                                 kernel_s={"void cg_tiled_kernel(float const*)": 0.5,
                                           "split_b_kernel": 0.1, "other": 0.3},
                                 breakdown={})
    solves = [(2059, 989, 300), (2059, 989, 400)]
    ctx = _ctx(trace, solves, {"steps": 1}, {"m": 989, "d": 3, "batch": 2048},
               {"enqueue": [0.002]})
    bound_s = sum(roofline.cg_solve_bound(*s)[0] for s in solves) * 1e-3
    assert readers.b2_roofline(ctx) == pytest.approx(100 * bound_s / 0.6)
    assert readers.idle_pct(ctx) == pytest.approx(10.0)
    assert readers.cg_steps_per(ctx, "steps") == 700
    assert readers.enqueue_ms(ctx, "steps") == pytest.approx(2.0)
    flops = 2.0 * 2059 * 989 ** 2 * 700 + 2.0 * 3 * 989 * (989 + 2048)
    assert readers.mfu(ctx, "steps") == pytest.approx(100 * flops / 165e12)
    assert readers.b3_roofline(ctx) is None  # no B3 kernel in the trace


def test_readers_return_nothing_without_a_trace():
    ctx = _ctx(None, [], {"steps": 1}, {"m": 1, "d": 1, "batch": 1})
    for fn in (readers.b2_roofline, readers.b3_roofline, readers.idle_pct):
        assert fn(ctx) is None
    assert readers.mfu(ctx, "steps") is None


def test_reduce_trace_unions_and_labels_gaps():
    events = [
        {"name": harness.STRETCH, "cat": "user_annotation", "ts": 0, "dur": 100},
        {"name": "k1", "cat": "kernel", "ts": 10, "dur": 20},
        {"name": "k2", "cat": "kernel", "ts": 20, "dur": 20},  # overlaps k1
        {"name": "k1", "cat": "kernel", "ts": 70, "dur": 10},
        {"name": "host_work", "cat": "cpu_op", "ts": 45, "dur": 20},
    ]
    reading = harness.reduce_trace(events, harness.STRETCH)
    assert reading.window_s == pytest.approx(100e-6)
    assert reading.busy_s == pytest.approx(40e-6)  # [10, 40] and [70, 80]
    assert reading.kernel_s["k1"] == pytest.approx(30e-6)
    idle = dict(reading.breakdown["idle_gaps"])
    assert idle["host_work"] == pytest.approx(30e-6)  # the gap [40, 70]
    assert math.isclose(sum(idle.values()), 60e-6)
