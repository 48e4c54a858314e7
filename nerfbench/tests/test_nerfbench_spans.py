"""The readers of the program's own spans (CPU only): each on a synthetic
traced stretch, None without spans, without a traced stretch or without
the recorder, and a tiny traced run that prints them."""

from __future__ import annotations

import builtins

import pytest

from nerfbench import harness
from nerfbench.tests.test_nerfbench_runs import run_line

spans = pytest.importorskip("keras_nerf_tpu_torch.spans")

MS = 1_000_000
TRAIN = {"kind": "train", "units": 2, "window_s": 1.0,
         "device_ops": [("k", 0.1)]}
RENDER = dict(TRAIN, kind="render")


def _span(name, start_ms, end_ms, parent=None, unit=None, csrc_launches=0):
    return spans.Span(name, start_ms * MS, end_ms * MS, parent, unit, 1,
                      csrc_launches)


# Two steps: a batch of 2 ms, then a step of 10 ms with two Adam updates of
# 1 and 2 ms and 72 launches; then 5 ms and an update of 1 ms, 70 launches.
# An update outside any step counts in no step.
STEPS = [
    _span("data.batch", 0, 2),
    _span("fit.step", 2, 12, unit=0, csrc_launches=72),
    _span("engine.update", 8, 9, 1, 0),
    _span("engine.update", 9, 11, 1, 0),
    _span("data.batch", 12, 14),
    _span("fit.step", 14, 19, unit=1, csrc_launches=70),
    _span("engine.update", 17, 18, 5, 1),
    _span("engine.update", 20, 21),
]
# Two frames of 8 and 6 ms, each packing for 1.5 ms, 20 launches each; a
# frame still open is no frame.
FRAMES = [
    _span("render.call", 0, 8, unit=0, csrc_launches=20),
    _span("engine.pack", 0, 1.5, 0, 0),
    _span("engine.chunk", 2, 7, 0, 0),
    _span("render.call", 8, 14, unit=1, csrc_launches=20),
    _span("engine.pack", 8, 9.5, 3, 1),
    spans.Span("render.call", 14 * MS, None, None, 2, 1, None),
]

READINGS = {
    "enqueue_ms.train": (STEPS, TRAIN, 7.5),
    "loader_ms.train": (STEPS, TRAIN, 2.0),
    "optimizer_ms.train": (STEPS, TRAIN, 2.0),
    "csrc_launches_per_step.train": (STEPS, TRAIN, 71.0),
    "enqueue_ms.render": (FRAMES, RENDER, 7.0),
    "pack_ms.render": (FRAMES, RENDER, 1.5),
    "csrc_launches_per_frame.render": (FRAMES, RENDER, 20.0),
}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_on_a_synthetic_stretch(monkeypatch, metric):
    found, stretch, value = READINGS[metric]
    read = harness.layer_reader(metric)
    monkeypatch.setattr(spans, "recorded", lambda: list(found))
    assert read(stretch) == pytest.approx(value)
    other = RENDER if stretch is TRAIN else TRAIN
    assert read(other) is None
    assert read(None) is None
    assert read(dict(stretch, device_ops=[])) is None
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert read(stretch) is None


def _after(earlier: list, found: list) -> list:
    """``earlier``, then ``found`` with its parents' indices moved past."""
    n = len(earlier)
    return earlier + [s._replace(parent=None if s.parent is None
                                 else s.parent + n) for s in found]


# What an earlier profile left behind: a step and a frame of their own,
# with work inside them, which no reading may count.
EARLIER = {
    "train": [_span("data.batch", -40, -36),
              _span("fit.step", -36, -20, unit=7, csrc_launches=500),
              _span("engine.update", -30, -22, 1, 7)],
    "render": [_span("render.call", -40, -20, unit=7, csrc_launches=99),
               _span("engine.pack", -40, -30, 0, 7)],
}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_keeps_the_stretch_alone(monkeypatch, metric):
    """Spans recorded before the stretch's last ``units`` steps or frames
    do not move a reading."""
    found, stretch, value = READINGS[metric]
    found = _after(EARLIER[stretch["kind"]], found)
    monkeypatch.setattr(spans, "recorded", lambda: list(found))
    assert harness.layer_reader(metric)(stretch) == pytest.approx(value)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_without_the_recorder_reads_nothing(monkeypatch, metric):
    """A program without the recorder (the parent of this change) gives
    nothing to read, and no reader raises."""
    found, stretch, _ = READINGS[metric]
    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "keras_nerf_tpu_torch" and "spans" in (fromlist or ()):
            raise ImportError("no spans")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    assert harness.layer_reader(metric)(stretch) is None


@pytest.mark.parametrize("name", ("k128_train_mse", "k128_render"))
def test_the_traced_stretch_alone_records_spans(monkeypatch, name):
    """A traced run records the program's spans over its stretch's steps or
    frames (up to two here, fewer if the window closes first) and nowhere
    else; an untraced run records none. (On the CPU the stretch has no
    device operations, so no reader reads them.)"""
    unit = "fit.step" if name == "k128_train_mse" else "render.call"
    spans.drain()
    run_line(monkeypatch, name, seconds=2.0, trace=1)
    found = spans.drain()
    units = [s.unit for s in found if s.name == unit]
    assert 1 <= len(units) <= 2
    assert units == list(range(units[0], units[0] + len(units)))
    assert found[0].name == ("data.batch" if unit == "fit.step" else unit)
    run_line(monkeypatch, name, seconds=0.5, trace=0)
    assert spans.drain() == []
