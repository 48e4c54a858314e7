"""Spans and counters at the port's layer boundaries, kept in memory on the
clock of ``time.time_ns()``.

The recorder is on while ``torch.profiler`` records: torch keeps a
module-level flag for such fast checks (``torch.autograd.profiler.
_is_profiler_enabled``), set from a profile's start to its stop. So a
benchmark's traced stretch, ``train_single --profile_dir``'s first epoch
and any profile a user takes record the program's spans, and nothing else
does. Off, a span site costs that flag test and gets one shared no-op
context back: no object, no clock read.

The records hold the newest profile's spans: a span site reached with the
profiler off ends a profile, and the first span of the next one forgets
what came before. At most ``MAX_RECORDS`` are kept, the older half dropped
when they fill, so a profiler that a long run keeps starting holds bounded
memory.

A span records its name, its start and end, the index of the span that
encloses it on its own thread (its parent), the thread, its unit (the
training step or the render call's frame, which the outermost span is
given and the spans inside it inherit) and ``csrc_launches``: the
hand-written kernels launched (:func:`csrc_launched`) between its entry and
its exit, on any thread, since autograd runs the backward on a thread of its
own while the caller waits.

The profiler's clock is this one: a host event lies at
``kineto_results.trace_start_ns() + 1000 * time_range.start`` ns, and an
event of an exported Chrome trace at ``baseTimeNanoseconds + 1000 * ts``. So
the spans lay over a device trace that records no host activity.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    """One recorded span; ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    unit: int | None
    tid: int
    csrc_launches: int | None


MAX_RECORDS = 1 << 16
_NOOP = contextlib.nullcontext()
_local = threading.local()
# [name, start, end, parent's record, unit, tid, csrc_launches], in opening
# order; a list's append needs no lock.
_records: list = []
_csrc_launches = 0
_on = False    # whether the last span site found the profiler recording


def csrc_launched() -> None:
    """Count one launch of a hand-written kernel (``KernelWrapper``)."""
    global _csrc_launches
    _csrc_launches += 1


def _thread() -> threading.local:
    """This thread's stack of open spans and its id, read once (the id is a
    system call)."""
    if not hasattr(_local, "stack"):
        _local.stack, _local.tid = [], threading.get_native_id()
    return _local


class _Open:
    __slots__ = ("_name", "_unit", "_record", "_launches")

    def __init__(self, name: str, unit: int | None):
        self._name, self._unit = name, unit

    def __enter__(self):
        thread = _thread()
        stack = thread.stack
        parent = stack[-1] if stack else None
        unit = self._unit
        if unit is None and parent is not None:
            unit = parent[4]
        record = [self._name, 0, None, parent, unit, thread.tid, None]
        if len(_records) >= MAX_RECORDS:
            del _records[:MAX_RECORDS // 2]
        _records.append(record)
        stack.append(record)
        self._record = record
        self._launches = _csrc_launches
        record[1] = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        record = self._record
        record[2] = time.time_ns()
        record[6] = _csrc_launches - self._launches
        _local.stack.pop()
        return False


def span(name: str, unit: int | None = None):
    """A context that records a span named ``name`` while the profiler
    records; ``unit`` the step or frame (else its parent's)."""
    global _on
    if not _profiler._is_profiler_enabled:
        _on = False
        return _NOOP
    if not _on:
        _on = True
        del _records[:]
    return _Open(name, unit)


def _spans(records: list) -> list[Span]:
    index = {id(r): i for i, r in enumerate(records)}
    return [Span(r[0], r[1], r[2], None if r[3] is None else
                 index.get(id(r[3])), r[4], r[5], r[6])
            for r in records]


def recorded() -> list[Span]:
    """The spans of the newest profile since the last :func:`drain`, in
    the order they opened (a parent before its children)."""
    return _spans(list(_records))


def drain() -> list[Span]:
    """:func:`recorded`, and forget them. A span still open comes back with
    ``end_ns`` None, and the spans opened inside it later have no
    parent."""
    global _records
    records, _records = _records, []
    return _spans(records)


def chrome_events(recorded: list[Span], base_ns: int = 0) -> list[dict]:
    """The finished spans of ``recorded`` as Chrome-trace complete events
    (``"X"``, category ``program_span``) for a trace whose
    ``baseTimeNanoseconds`` is ``base_ns``: ``ts`` and ``dur`` in us, on the
    thread that ran them, with the unit, the parent and ``csrc_launches``
    as ``args``."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
             "tid": s.tid, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"unit": s.unit, "parent": s.parent,
                      "csrc_launches": s.csrc_launches}}
            for s in recorded if s.end_ns is not None]
