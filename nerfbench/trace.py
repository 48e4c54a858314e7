"""A traced stretch of the window: ``torch.profiler`` over a few steps or
frames, reduced to the device's busy time, its operations by name and its
idle gaps with the host's CUDA runtime call meanwhile.

The stretch starts and ends on a synchronize, so every device operation in
the trace belongs to it and ``window_s``, the host clock between the two,
bounds ``busy_s``, the union of the device's operation spans. The profiler
slows the host (an MSE step 86 ms traced against 74-79 untraced), so the
same number of steps or frames just before it, between synchronizes too
but not traced, gives ``plain_s``: the wall time that shares of the wall
are taken over.
"""

from __future__ import annotations

import time

import torch

from nerfbench import clock



def activities(device: torch.device) -> tuple:
    """The card's activity alone: recording every host operation as well
    slowed an L1 step by 60% and so read as idle time on the card. Without
    a card (the tests) the host's, which no reader counts as the device's."""
    if device.type == "cuda":
        return (torch.profiler.ProfilerActivity.CUDA,)
    return (torch.profiler.ProfilerActivity.CPU,)


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and arguments."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


class Stretch:
    """A plain stretch of ``units`` steps or frames, then a traced one of
    as many, starting after ``first`` of them. Call :meth:`between` with
    the count handed to the program so far before each one starts, and
    :meth:`close` with the count once the window has closed. Then
    ``plain_units`` and ``plain_s`` (the plain stretch), ``units`` (steps
    or frames traced), ``window_s``, ``busy_s``, ``device_ops`` (``[(name,
    seconds)]``, one entry a device operation) and ``idle_gaps`` (``[(host
    activity, seconds)]``, longest first)."""

    def __init__(self, device: torch.device, first: int, units: int):
        self.device = device
        self.first, self.planned = first, units
        self.prof = None
        self.units = 0
        self.plain_units = 0
        self.plain_s = 0.0
        self._plain_t0 = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.device_ops: list[tuple[str, float]] = []
        self.idle_gaps: list[tuple[str, float]] = []
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None

    def between(self, handed: int) -> None:
        if self.done:
            return
        if handed == self.first - self.planned:
            clock.sync(self.device)
            self._plain_t0 = time.perf_counter()
        elif handed == self.first and not self.active:
            clock.sync(self.device)
            if self._plain_t0 is not None:
                self.plain_s = time.perf_counter() - self._plain_t0
                self.plain_units = self.planned
            self._start()
        elif handed == self.first + self.planned and self.active:
            self._stop(self.planned)

    def close(self, handed: int) -> None:
        if self.active:
            self._stop(handed - self.first)

    def warm(self) -> None:
        """One profiled no-op in set-up: the profiler's own start-up (CUPTI's,
        seconds the first time in a process) stays out of the window."""
        with torch.profiler.profile(activities=activities(self.device)) as prof:
            torch.ones(1, device=self.device).add_(1)
            clock.sync(self.device)
        prof.events()

    def _start(self) -> None:
        self.prof = torch.profiler.profile(activities=activities(self.device))
        self.prof.start()
        self._t0 = time.perf_counter()

    def _stop(self, units: int) -> None:
        clock.sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self._reduce(self.prof.events())
        self.prof = None
        self.units = units
        self.done = True

    def _reduce(self, events) -> None:
        cpu = torch.autograd.DeviceType.CPU
        dev, host = [], []
        for ev in events:
            span = (ev.time_range.start, ev.time_range.end)
            if ev.device_type != cpu and not ev.is_user_annotation:
                dev.append((*span, ev.name))
            elif ev.device_type == cpu:
                host.append((*span, ev.name))
        dev.sort()
        self.device_ops = [(short_name(n), (e - s) * 1e-6) for s, e, n in dev]
        busy, reach, gaps = 0.0, None, []
        for s, e, _ in dev:
            if reach is not None and s > reach:
                gaps.append((reach, s))
            busy += max(0.0, e - max(s, reach if reach is not None else s))
            reach = e if reach is None else max(reach, e)
        self.busy_s = busy * 1e-6
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        self.idle_gaps = [(self._host_at(host, (a + b) / 2), (b - a) * 1e-6)
                          for a, b in gaps[:10]]

    @staticmethod
    def _host_at(host, at: float) -> str:
        """The narrowest host call in the trace (the CUDA runtime's) that
        covers the instant ``at``."""
        inner = None
        for s, e, name in host:
            if s <= at <= e and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        return inner[2] if inner else "host: no runtime call"


def top_ops(device_ops, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time, summed by name."""
    total: dict[str, float] = {}
    for name, sec in device_ops:
        total[name] = total.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:n]


def traced_stretch(trace: bool, device: torch.device,
                   spec: dict) -> Stretch | None:
    """The cell's stretch (``{"from", "units"}`` of its workload file),
    its profiler warmed, where the run is traced on a card."""
    if not trace:
        return None
    stretch = Stretch(device, spec["from"], spec["units"])
    stretch.warm()
    return stretch


def describe(stretch: Stretch | None, out, layer: dict) -> dict:
    """``layer`` (what the per-layer readers read) with the stretch's
    readings, which also go into ``out``'s device fields and breakdown."""
    if stretch is None or not stretch.done:
        return layer
    layer.update(units=stretch.units, window_s=stretch.window_s,
                 busy_s=stretch.busy_s, device_ops=stretch.device_ops,
                 plain_units=stretch.plain_units, plain_s=stretch.plain_s)
    out.busy_s, out.window_s = stretch.busy_s, stretch.window_s
    out.breakdown = {"device_ops": top_ops(stretch.device_ops),
                     "idle_gaps": [list(g) for g in stretch.idle_gaps]}
    return layer
