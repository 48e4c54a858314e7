"""What the readers of the program's own spans share.

The port records spans (``keras_nerf_tpu_torch.spans``) while
``torch.profiler`` records, and keeps those of the newest profile alone.
In a run the newest profile is the traced stretch, which the readers read
just after it stops. They keep, besides, only the spans from the end of the
step or frame before the stretch's last ``units`` ones to the end of the
last, so that what an earlier profile left behind never counts. A program
without the recorder gives nothing to read."""

from __future__ import annotations

from nerfbench.layer_metrics import _stretch

# The span of one step or frame, by the stretch's kind.
UNIT = {"train": "fit.step", "render": "render.call"}


def recorded(stretch: dict | None, kind: str) -> list | None:
    """The program's spans of a traced stretch of this kind, or None."""
    if not _stretch.traced(stretch, kind):
        return None
    try:
        from keras_nerf_tpu_torch import spans
    except ImportError:
        return None
    found = spans.recorded()
    ends = [s.end_ns for s in found
            if s.name == UNIT[kind] and s.end_ns is not None]
    if not ends:
        return []
    before = ends[-stretch["units"] - 1] if len(ends) > stretch["units"] \
        else None
    keep = [i for i, s in enumerate(found)
            if s.end_ns is not None and s.end_ns <= ends[-1]
            and (before is None or s.start_ns >= before)]
    index = {i: k for k, i in enumerate(keep)}
    return [found[i]._replace(parent=index.get(found[i].parent))
            for i in keep]


def _inside(found: list, i: int, unit: str) -> bool:
    """Whether span ``i`` is a ``unit`` span or opened inside one."""
    while i is not None:
        if found[i].name == unit:
            return True
        i = found[i].parent
    return False


def _closed(found: list, name: str) -> list:
    return [i for i, s in enumerate(found)
            if s.name == name and s.end_ns is not None]


def mean_ms(stretch: dict | None, kind: str, name: str) -> float | None:
    """The mean duration of the stretch's ``name`` spans, in ms."""
    found = recorded(stretch, kind)
    ids = _closed(found or [], name)
    if not ids:
        return None
    return sum(found[i].end_ns - found[i].start_ns for i in ids) / (
        1e6 * len(ids))


def ms_per_unit(stretch: dict | None, kind: str, name: str,
                unit: str) -> float | None:
    """The ms of the ``name`` spans inside ``unit`` spans (a step's or a
    frame's), over the number of those."""
    found = recorded(stretch, kind)
    units = _closed(found or [], unit)
    if not units:
        return None
    total = sum(found[i].end_ns - found[i].start_ns
                for i in _closed(found, name) if _inside(found, i, unit))
    return total / (1e6 * len(units))


def launches_per_unit(stretch: dict | None, kind: str,
                      unit: str) -> float | None:
    """The mean ``csrc_launches`` of the stretch's ``unit`` spans."""
    found = recorded(stretch, kind)
    units = _closed(found or [], unit)
    if not units:
        return None
    return sum(found[i].csrc_launches for i in units) / len(units)
