"""The trace reduction on a hand-made Chrome trace."""

import pytest

from portbench.harness import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(trace.WINDOW_SPAN, "user_annotation", 0, 100),
    _x("nerf.train_step", "user_annotation", 0, 100),
    _x("nerf.feed", "user_annotation", 0, 10),
    _x("other.span", "user_annotation", 0, 100),
    _x("void (anonymous namespace)::k1<3>((anonymous namespace)::Args)", "kernel", 10, 20),
    _x("k2(float const*, int)", "kernel", 25, 15),
    _x("Memcpy HtoD", "gpu_memcpy", 60, 10),
    _x("aten::mm", "cpu_op", 40, 15),
    _x("aten::addmm", "cpu_op", 42, 5),
    _x("aten::item", "cpu_op", 70, 25),
    _x("k3(int)", "kernel", 120, 10),
]


def test_base_name():
    assert trace.base_name("void (anonymous namespace)::k1<3>((anonymous namespace)::Args)") == "k1"
    assert trace.base_name("sum_slices(float const*, int, long, float*)") == "sum_slices"
    assert trace.base_name("void at::native::vectorized_elementwise_kernel<4, F>(int, F)") == \
        "vectorized_elementwise_kernel"


def test_reduce():
    r = trace.reduce(EVENTS, ("nerf.",))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)             # [10, 40] and [60, 70]; k3 is outside
    assert r["kernels"] == pytest.approx({"k1": 20e-6, "k2": 15e-6, "gpu_memcpy": 10e-6})
    assert r["idle"] == pytest.approx({"nerf.feed / python": 10e-6, "nerf.train_step / aten::mm": 20e-6,
                                       "nerf.train_step / aten::item": 30e-6})
    assert trace.top(r["idle"], 1) == [["nerf.train_step / aten::item", pytest.approx(30e-6)]]


def test_reduce_needs_the_window():
    with pytest.raises(RuntimeError):
        trace.reduce(EVENTS[1:], ())
