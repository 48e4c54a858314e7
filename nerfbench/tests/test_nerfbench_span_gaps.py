"""``python -m nerfbench.span_gaps`` (CPU only): the idle time laid over
the program's spans on a synthetic window, and a tiny traced run with the
recorder on and off."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest

from nerfbench import harness, span_gaps
from nerfbench.tests.test_nerfbench_runs import CPU, tiny_cell

spans = pytest.importorskip("keras_nerf_tpu_torch.spans")
MS = 1_000_000


def _span(name, start_ms, end_ms, parent=None):
    return spans.Span(name, start_ms * MS, end_ms * MS, parent, 0, 1, 0)


def test_idle_time_goes_to_the_innermost_open_span():
    """A window of 100 ms with the device busy over 10-20, 30-40 and 70-90:
    60 ms idle, of which 5 before the step opened (outside); the gaps are
    those between device operations."""
    found = [_span("fit.step", 5, 95), _span("engine.update", 25, 35, 0),
             _span("data.batch", 95, 100)]
    device = [(10 * MS, 20 * MS), (30 * MS, 40 * MS), (70 * MS, 90 * MS)]
    host = [(50 * MS, 60 * MS, "cudaLaunchKernel")]
    got = span_gaps.analyse(found, device, host, 0, 100 * MS, 1)
    assert got["idle_pct"] == pytest.approx(60.0)
    assert got["host_wait_pct"] == pytest.approx(55.0)
    assert got["idle_ms_per_unit_by_span"] == pytest.approx(
        {"fit.step": 45.0, "engine.update": 5.0, "data.batch": 5.0,
         "outside": 5.0})
    assert got["host_ms_per_unit_by_span"] == pytest.approx(
        {"fit.step": 90.0, "engine.update": 10.0, "data.batch": 5.0})
    assert got["top_gaps"] == [
        ["fit.step|cudaLaunchKernel", 30.0],
        ["engine.update|host: no runtime call", 10.0]]


@pytest.mark.parametrize("off", [False, True], ids=["on", "off"])
def test_a_tiny_traced_run_gives_the_idle_by_span(monkeypatch, off):
    """On the CPU the trace holds no device operation, so the whole window
    reads idle; with the recorder on the steps' spans hold most of it, off
    none."""
    cell = tiny_cell("k128_train_mse")
    monkeypatch.setattr(harness, "find_cell", lambda _name, bench=None: cell)
    out = io.StringIO()
    argv = ["--workload", "k128_train_mse", "--seed", str(2 ** 31 + 7),
            "--seconds", "2.0"] + (["--off"] if off else [])
    with redirect_stdout(out):
        assert span_gaps.main(argv, device=CPU) == 0
    lines = out.getvalue().strip().splitlines()
    assert json.loads(lines[-2])["correct"]
    last = json.loads(lines[-1])
    got = last["span_gaps"]
    assert last["recorder"] is not off
    assert got["units"] >= 1 and got["idle_pct"] == pytest.approx(100.0)
    assert got["top_gaps"] == []
    if off:
        assert got["host_ms_per_unit_by_span"] == {}
        assert got["host_wait_pct"] == 0.0
    else:
        assert "fit.step" in got["host_ms_per_unit_by_span"]
        assert got["host_wait_pct"] > 0.0
