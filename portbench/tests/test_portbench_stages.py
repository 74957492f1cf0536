"""The stage reduction (``harness/stages.py``) on a hand-made Chrome trace:
device time by the span that launched it (through the launch's
correlation id), idle gaps by the spans around their midpoint, launch
counts; and the program's spans leave ``trace.reduce``'s totals as they
are."""

import pytest

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils.profiling import SPAN_PREFIXES
from portbench.harness import stages, trace


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


BENCH = [
    _x(trace.WINDOW_SPAN, "user_annotation", 0, 200),
    _x("nerf.train_step", "user_annotation", 0, 150),
    _x("aten::mm", "cpu_op", 55, 20),
    # launches: corr 1-4 and 6 put work on the card, corr 5 waits for it
    _x("cudaLaunchKernel", "cuda_runtime", 22, 2, 1),
    _x("cuLaunchKernel", "cuda_driver", 72, 2, 2),
    _x("cudaLaunchKernel", "cuda_runtime", 105, 2, 3),
    _x("cudaMemcpyAsync", "cuda_runtime", 110, 2, 4),
    _x("cudaStreamSynchronize", "cuda_runtime", 120, 5, 5),
    _x("cudaLaunchKernel", "cuda_runtime", 190, 2, 6),
    _x("bundle_loss_kernel(Args)", "kernel", 30, 30, 1),     # launched in nerf.coarse, runs on
    _x("bundle_loss_kernel(Args)", "kernel", 80, 20, 2),
    _x("multi_tensor_apply_kernel", "kernel", 110, 5, 3),
    _x("Memcpy DtoH", "gpu_memcpy", 120, 5, 4),
    _x("k(int)", "kernel", 195, 15, 6),                      # clipped to the window: 5
]
PROGRAM = [
    _x("nerf.field", "user_annotation", 10, 90),
    _x("nerf.coarse", "user_annotation", 10, 40),
    _x("nerf.fine", "user_annotation", 60, 40),
    _x("kernel.bundle_loss", "user_annotation", 20, 10),
    _x("kernel.bundle_loss", "user_annotation", 70, 10),
    _x("nerf.adam", "user_annotation", 100, 40),
    _x("nerf.adam", "user_annotation", 110, 10),            # overlapping instances count once
    _x("serve.other", "user_annotation", 0, 200),            # another namespace
]
EVENTS = BENCH + PROGRAM


def test_stages_attribute_busy_idle_and_launches():
    r = stages.reduce(EVENTS, SPAN_PREFIXES)
    # idle gaps [0, 30] (mid 15), [60, 80] (70), [100, 110] (105), [115, 120]
    # (117.5), [125, 195] (160, in no program span)
    # the benchmark's nerf.train_step shares the program's namespace
    want = {"nerf.train_step": (1, 60, 65, 4), "nerf.field": (1, 50, 50, 2), "nerf.coarse": (1, 30, 30, 1),
            "nerf.fine": (1, 20, 20, 1), "kernel.bundle_loss": (2, 50, 20, 2), "nerf.adam": (2, 10, 15, 2)}
    assert set(r["stages"]) == set(want)
    for name, (count, busy, idle, launches) in want.items():
        got = r["stages"][name]
        assert got["count"] == count, name
        assert got["busy_s"] == pytest.approx(busy * 1e-6), name
        assert got["idle_s"] == pytest.approx(idle * 1e-6), name
        assert got["launches"] == launches, name
    assert r["launches"] == 5


def test_stages_take_any_prefixes():
    r = stages.reduce(EVENTS, ("serve.",))
    assert list(r["stages"]) == ["serve.other"]
    whole = r["stages"]["serve.other"]
    assert (whole["busy_s"], whole["idle_s"], whole["launches"]) == (pytest.approx(65e-6), pytest.approx(135e-6), 5)


def test_program_spans_leave_the_totals_as_they_are():
    """busy, window, time by kernel and the idle sum read the same with and
    without the program's spans, whatever prefixes label the gaps; with
    the program's namespace the innermost program span names a gap."""
    base = trace.reduce(BENCH, ("nerf.",))
    for prefixes in (("nerf.",), ("nerf.",) + SPAN_PREFIXES):
        got = trace.reduce(EVENTS, prefixes)
        assert got["busy_s"] == base["busy_s"] and got["window_s"] == base["window_s"]
        assert got["kernels"] == base["kernels"]
        assert sum(got["idle"].values()) == pytest.approx(sum(base["idle"].values()))
    labels = trace.reduce(EVENTS, ("serve.",) + SPAN_PREFIXES)["idle"]
    assert labels["kernel.bundle_loss / aten::mm"] == pytest.approx(20e-6)
    assert labels["nerf.coarse / python"] == pytest.approx(30e-6)      # the gap [0, 30] by its midpoint
    assert "serve.other / python" in labels


def test_ms_a_step():
    ctx = {"steps": 2, **stages.reduce(EVENTS, SPAN_PREFIXES)}
    assert stages.ms_a_step(ctx, "nerf.field") == pytest.approx(1e3 * 100e-6 / 2)
    assert stages.ms_a_step(ctx, "nerf.rays") is None
    assert stages.ms_a_step({"steps": 2}, "nerf.field") is None
    lines = stages.table(ctx["stages"], 2)
    assert len(lines) == 1 + len(ctx["stages"]) and lines[1].split()[0] == "kernel.bundle_loss"


def test_stages_need_the_window():
    with pytest.raises(RuntimeError):
        stages.reduce(EVENTS[1:], SPAN_PREFIXES)
