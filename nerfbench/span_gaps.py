"""The card's idle time in one traced run, by the program span open on the
host meanwhile:

    python -m nerfbench.span_gaps --workload <cell> --seed <n> \
        --seconds <s> [--off]

It runs the cell as ``python -m nerfbench.run ... --trace 1`` does and
prints that run's output, then one JSON line ``{"span_gaps": ...}``: the
traced window's idle share, the part of it while the host was inside a
program span (``host_wait_pct``), the idle ms a step or frame by the
innermost span open at each instant (``outside``: none), each span's host
ms a step or frame, and the ten longest gaps between device operations as
``<span>|<runtime call>``. The device trace lies on the spans' clock at
``trace_start_ns() + 1000 * time_range``. ``--off`` keeps the port's
recorder off: the same run without spans, for the recorder's cost. The
benchmark's runs never run this; it is the computation that ``trace.py``
would take on to report ``host_wait_pct`` and name its idle gaps.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import sys
import time
import types

from nerfbench import run, trace


def analyse(found: list, device: list, host: list, w0: int, w1: int,
            units: int) -> dict:
    """``found``: the program's spans; ``device``: the device operations'
    ``(start, end)``, sorted; ``host``: the runtime calls' ``(start, end,
    name)``; the window ``[w0, w1]``; all in ns on the spans' clock."""
    depth = []
    for s in found:
        depth.append(0 if s.parent is None else depth[s.parent] + 1)
    idle, gaps, reach = [], [], w0
    for k, (s, e) in enumerate(device):
        if s > reach:
            idle.append((reach, s))
            if k:
                gaps.append((reach, s))
        reach = max(reach, e)
    if w1 > reach:
        idle.append((reach, w1))
    marks = collections.defaultdict(list)    # instant: [(+1 | -1, span)]
    for i, s in enumerate(found):
        if s.end_ns is not None:
            marks[s.start_ns].append((1, i))
            marks[s.end_ns].append((-1, i))
    for a, b in idle:
        marks[a].append((1, None))
        marks[b].append((-1, None))

    def innermost(open_spans) -> str:
        if not open_spans:
            return "outside"
        return found[max(open_spans,
                         key=lambda i: (depth[i], found[i].start_ns))].name

    open_spans, idle_open = set(), 0
    by_span = collections.Counter()
    times = sorted(marks)
    for t, t_next in zip(times, times[1:]):
        for step, i in marks[t]:
            if i is None:
                idle_open += step
            elif step > 0:
                open_spans.add(i)
            else:
                open_spans.discard(i)
        if idle_open > 0:
            by_span[innermost(open_spans)] += t_next - t

    def label(at: float) -> str:
        inside = {i for i, s in enumerate(found)
                  if s.end_ns is not None and s.start_ns <= at <= s.end_ns}
        return f"{innermost(inside)}|{trace.Stretch._host_at(host, at)}"

    host_ns = collections.Counter()
    for s in found:
        if s.end_ns is not None:
            host_ns[s.name] += s.end_ns - s.start_ns
    window = w1 - w0
    idle_ns = sum(by_span.values())
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "units": units, "window_ms_per_unit": window / 1e6 / units,
        "idle_pct": 100.0 * idle_ns / window,
        "host_wait_pct": 100.0 * (idle_ns - by_span["outside"]) / window,
        "idle_ms_per_unit_by_span": {k: v / 1e6 / units
                                     for k, v in by_span.most_common()},
        "host_ms_per_unit_by_span": {k: v / 1e6 / units
                                     for k, v in host_ns.most_common()},
        "top_gaps": [[label((a + b) / 2), (b - a) / 1e6]
                     for a, b in gaps[:10]],
    }


@contextlib.contextmanager
def _kept(keep: dict):
    """``Stretch`` keeping, besides its own readings, the window's start on
    the spans' clock and every device operation's and runtime call's
    span."""
    import torch

    start, reduce = trace.Stretch._start, trace.Stretch._reduce

    def _start(self):
        start(self)
        keep["w0"] = time.time_ns()

    def _reduce(self, events):
        base = self.prof.profiler.kineto_results.trace_start_ns()
        cpu = torch.autograd.DeviceType.CPU
        events = list(events)
        for ev in events:
            at = (base + 1000 * ev.time_range.start,
                  base + 1000 * ev.time_range.end)
            if ev.device_type != cpu and not ev.is_user_annotation:
                keep["device"].append(at)
            elif ev.device_type == cpu:
                keep["host"].append((*at, ev.name))
        keep["stretch"] = self
        reduce(self, events)

    trace.Stretch._start, trace.Stretch._reduce = _start, _reduce
    try:
        yield
    finally:
        trace.Stretch._start, trace.Stretch._reduce = start, reduce


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--off", action="store_true",
                   help="keep the port's span recorder off")
    args = p.parse_args(argv)
    from keras_nerf_tpu_torch import spans

    keep = {"device": [], "host": []}
    spans.drain()
    recorder = spans._profiler
    if args.off:
        spans._profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    out = io.StringIO()
    try:
        with _kept(keep), contextlib.redirect_stdout(out):
            rc = run.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", "1"], device=device)
    finally:
        spans._profiler = recorder
    print(out.getvalue(), end="")
    stretch = keep.get("stretch")
    if rc != 0 or stretch is None or not stretch.units:
        print("span_gaps: the run traced no stretch", file=sys.stderr)
        return rc or 1
    w0 = keep["w0"]
    gaps = analyse(spans.recorded(), sorted(keep["device"]), keep["host"],
                   w0, w0 + int(stretch.window_s * 1e9), stretch.units)
    print(json.dumps({"span_gaps": gaps, "recorder": not args.off}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
