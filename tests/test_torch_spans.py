"""The port's span recorder (``keras_nerf_tpu_torch.spans``): off unless
``torch.profiler`` records, one profile's spans kept and no more than its
bound, nesting and units per thread, the span tree of ``NeRF.fit`` and
``predict_and_render_images``, the kernels' launch counter, the profiler's
clock and ``--profile_dir``'s export.

The clock case has a ``cuda``-marked twin that runs on the card:

    python -m pytest -m cuda tests/test_torch_spans.py
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import json
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from keras_nerf_tpu_torch import spans
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRF

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _empty_recorder():
    spans.drain()
    yield
    spans.drain()


def _tree(found):
    """``(name, parent's name, unit)`` of each span, in opening order."""
    return [(s.name, None if s.parent is None else found[s.parent].name,
             s.unit) for s in found]


def test_off_records_nothing_and_opens_no_span():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("fit.step", unit=3) is spans._NOOP
    with spans.span("fit.step", unit=3):
        with spans.span("engine.chunk"):
            pass
    assert spans.recorded() == []


def test_nesting_parents_units_and_counts():
    with profile(activities=CPU):
        with spans.span("fit.step", unit=7):
            with spans.span("engine.chunk"):
                pass
            with spans.span("engine.update", unit=9):
                pass
        with spans.span("data.batch"):
            pass
    found = spans.drain()
    assert _tree(found) == [("fit.step", None, 7),
                            ("engine.chunk", "fit.step", 7),
                            ("engine.update", "fit.step", 9),
                            ("data.batch", None, None)]
    assert [s.csrc_launches for s in found] == [0] * 4
    assert all(s.start_ns <= s.end_ns for s in found)
    outer, inner = found[0], found[1]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert spans.recorded() == []


def test_each_thread_nests_its_own_spans():
    ready = threading.Barrier(2, timeout=30)

    def work(unit):
        with spans.span("fit.step", unit=unit):
            ready.wait()
            with spans.span("engine.chunk"):
                ready.wait()

    with profile(activities=CPU):
        threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    found = spans.drain()
    assert len(found) == 4
    for s in found:
        if s.name == "engine.chunk":
            parent = found[s.parent]
            assert parent.name == "fit.step" and parent.tid == s.tid
            assert s.unit == parent.unit
    assert {s.unit for s in found} == {1, 2}
    assert len({s.tid for s in found}) == 2


def test_drain_leaves_an_open_span_without_children():
    with profile(activities=CPU):
        with spans.span("fit.epoch_end"):
            first = spans.drain()
            with spans.span("engine.chunk"):
                pass
    assert [(s.name, s.end_ns) for s in first] == [("fit.epoch_end", None)]
    assert _tree(spans.drain()) == [("engine.chunk", None, None)]


def test_a_new_profile_forgets_the_last_ones_spans():
    """The records hold the newest profile's spans: a span site reached
    with the profiler off ends a profile, and the next one's first span
    forgets what the last recorded."""
    with profile(activities=CPU):
        with spans.span("fit.step", unit=0):
            pass
    with spans.span("fit.step", unit=1):
        pass
    assert [s.unit for s in spans.recorded()] == [0]
    with profile(activities=CPU):
        with spans.span("fit.step", unit=2):
            pass
        with spans.span("fit.step", unit=3):
            pass
    assert [s.unit for s in spans.recorded()] == [2, 3]


def test_the_records_keep_at_most_their_bound(monkeypatch):
    """A profile longer than ``MAX_RECORDS`` spans keeps its newest ones:
    the older half goes when the records fill, and a parent that went
    leaves its children without one."""
    monkeypatch.setattr(spans, "MAX_RECORDS", 8)
    with profile(activities=CPU):
        with spans.span("fit.epoch_end"):
            for unit in range(10):
                with spans.span("fit.step", unit=unit):
                    pass
    found = spans.recorded()
    assert [s.unit for s in found] == [3, 4, 5, 6, 7, 8, 9]
    assert {s.parent for s in found} == {None}


def _scene(tmp_path):
    from keras_nerf_tpu_torch.data import DatasetLoader
    from keras_nerf_tpu_torch.data.synthetic import write_synthetic_scene

    scene = write_synthetic_scene(str(tmp_path / "scene"), image_wh=8,
                                  n_train=2, n_val=1, n_test=1)
    train, val, _ = DatasetLoader(scene, True, device="cpu").load_dataset(
        batch_size=1, image_width=8, image_height=8, near=2.0, far=6.0,
        n_sample=8, seed=3)
    return train, val


def _l1(y_true, y_pred):
    return torch.mean(torch.abs(y_pred - y_true))


@pytest.mark.parametrize("loss", ["mse", _l1], ids=["fused", "autograd"])
def test_fit_and_render_give_the_span_tree(tmp_path, loss):
    train, val = _scene(tmp_path)
    nerf = NeRF(n_coarse=8, n_fine=8, n_layers=2).compile(
        image_height=8, image_width=8, ray_chunks=32, white_background=True,
        device="cpu", seed=3, loss=loss)
    rays = next(iter(val))[1]
    with profile(activities=CPU):
        nerf.fit(train, epochs=1, verbose=False)
        nerf.predict_and_render_images(rays)
        nerf.predict_and_render_images(rays)
    found = spans.drain()
    chunk = [("engine.chunk", "fit.step")]
    if loss == "mse":
        step = [("engine.pack", "fit.step"), *chunk * 2,
                ("engine.pack", "fit.step")]
    else:
        step = [*chunk, ("engine.forward", "engine.chunk"),
                ("engine.backward", "engine.chunk")] * 2
    step = [("data.batch", None), ("fit.step", None), *step,
            *[("engine.update", "fit.step")] * 2]
    frame = [("render.call", None), ("engine.pack", "render.call"),
             ("engine.chunk", "render.call"), ("engine.chunk", "render.call")]
    assert [t[:2] for t in _tree(found)] == (
        step * 2 + [("fit.epoch_end", None)] + frame * 2)
    units = [s.unit for s in found]
    n = len(step)
    assert units[:2 * n] == [None] + [0] * (n - 1) + [None] + [1] * (n - 1)
    assert units[2 * n:] == [None] + [0] * 4 + [1] * 4
    assert {s.csrc_launches for s in found} == {0}


def test_kernel_launches_count_in_the_open_spans(monkeypatch):
    """A ``KernelWrapper`` launch (a stub on a fake card) counts in every
    open span, and its own ``launches`` as before; the plain version counts
    in neither."""
    calls = []
    wrapper = trm.KernelWrapper("stub", lambda x: "plain",
                                lambda x: calls.append(x) or "kernel",
                                "stub.cu", "stub.py")
    card = types.SimpleNamespace(device=torch.device("cuda"))
    x = torch.ones(1)
    with profile(activities=CPU):
        with spans.span("fit.step", unit=0):
            with spans.span("engine.chunk"):
                with monkeypatch.context() as m:
                    m.setattr(trm, "_first_tensor", lambda a: card)
                    assert wrapper(x) == wrapper(x) == "kernel"
                assert wrapper(x) == "plain"
            with monkeypatch.context() as m:
                m.setattr(trm, "_first_tensor", lambda a: card)
                wrapper(x)
    assert wrapper.launches == 3 and len(calls) == 3
    found = spans.drain()
    assert [s.csrc_launches for s in found] == [3, 2]


def test_span_covers_a_profiled_range_on_the_profilers_clock():
    """The profiler's host events lie at ``trace_start_ns() + 1000 *
    time_range`` on ``time.time_ns()``'s clock: a span taken just outside a
    ``record_function`` range covers it."""
    with profile(activities=CPU) as prof:
        with spans.span("outer"):
            with record_function("inner"):
                torch.ones(64).add_(1)
    base = prof.profiler.kineto_results.trace_start_ns()
    inner = [e for e in prof.events() if e.name == "inner"]
    (outer,) = spans.drain()
    assert len(inner) == 1
    assert outer.start_ns <= base + 1000 * inner[0].time_range.start
    assert outer.end_ns >= base + 1000 * inner[0].time_range.end


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_covers_the_runtime_call_on_the_card(cuda_device):
    """On the card, with the device's activity alone (as the benchmark
    traces), a span around ``torch.cuda.synchronize()`` covers the
    runtime's ``cudaDeviceSynchronize`` event."""
    x = torch.ones(1 << 20, device=cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.add_(1)
        with spans.span("sync"):
            torch.cuda.synchronize(cuda_device)
    base = prof.profiler.kineto_results.trace_start_ns()
    (sync,) = spans.drain()
    covered = [e for e in prof.events() if e.name == "cudaDeviceSynchronize"
               and sync.start_ns <= base + 1000 * e.time_range.start
               and base + 1000 * e.time_range.end <= sync.end_ns]
    assert len(covered) == 1


def test_profile_dir_trace_holds_the_spans_on_its_clock(tmp_path):
    """``ProfileFirstEpoch`` (``--profile_dir``) writes the first epoch's
    spans, its end among them, into its Chrome trace as complete events on
    the trace's clock: every chunk's span covers some of the profiler's
    operator events."""
    from keras_nerf_tpu_torch.train_single import ProfileFirstEpoch

    train, _ = _scene(tmp_path)
    nerf = NeRF(n_coarse=8, n_fine=8, n_layers=2).compile(
        image_height=8, image_width=8, ray_chunks=32, white_background=True,
        device="cpu", seed=3)
    nerf.fit(train, epochs=2, verbose=False,
             callbacks=[ProfileFirstEpoch(str(tmp_path / "prof"))])
    with open(tmp_path / "prof" / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine if e["name"] != "engine.chunk"] == [
        "data.batch", "fit.step", "engine.pack", "engine.pack",
        "engine.update", "engine.update"] * 2 + ["fit.epoch_end"]
    assert [e["args"]["unit"] for e in mine if e["name"] == "fit.step"] == [
        0, 1]
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "cpu_op"]
    chunks = [(e["ts"], e["ts"] + e["dur"]) for e in mine
              if e["name"] == "engine.chunk"]
    assert len(chunks) == 4
    for a, b in chunks:
        assert any(a <= s and e <= b for s, e in ops)
    assert spans.recorded() == []    # the second epoch was not profiled
