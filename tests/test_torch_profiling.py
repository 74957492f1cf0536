"""Port parity: utils/profiling.py (the step timer and the profiler trace)
against the reference's (CPU)."""

import glob
import json
import os
import time

import pytest
import torch

from imagesequenceregistrationfor6dposeestimationlabeling_tpu.utils import profiling as jprof
from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def _scripted_clock(monkeypatch, stamps):
    it = iter(stamps)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("skip_first,n_steps", [(2, 5), (2, 2), (0, 3), (4, 1)])
def test_step_timer_matches_reference(monkeypatch, skip_first, n_steps):
    """Each step's (enter, exit) stamps from one script: the same times, the
    same steady steps and the same summaries (fewer steps than skip_first
    keep them all)."""
    stamps = [x for i in range(n_steps) for x in (10.0 * i, 10.0 * i + 0.25 * (i + 1))]
    timers = []
    for timer in (jprof.StepTimer(skip_first), tprof.StepTimer(skip_first, device="cpu")):
        _scripted_clock(monkeypatch, stamps)
        for _ in range(n_steps):
            with timer as t:
                assert t is timer
        timers.append(timer)
    ref, port = timers
    assert port.times == ref.times == [0.25 * (i + 1) for i in range(n_steps)]
    assert port.steady == ref.steady
    assert port.steps_per_sec() == ref.steps_per_sec()
    assert port.mean_ms() == ref.mean_ms()


def test_step_timer_waits_for_the_card_only_on_cuda(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    with tprof.StepTimer(device="cpu"):
        pass
    with tprof.StepTimer():
        pass
    assert synced == []
    with tprof.StepTimer(device="cuda:0") as t:
        pass
    assert synced == [torch.device("cuda:0")] * 2 and len(t.times) == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as prof:
        x = torch.randn(64, 64)
        y = (x @ x).relu().sum()
    assert float(y) >= 0.0
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
