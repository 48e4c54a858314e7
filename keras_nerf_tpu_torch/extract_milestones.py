"""The wall-clock minutes at which a training run's val fine PSNR first
crosses each threshold, from its run log (port of
``scripts/extract_milestones.py``), for ``docs/QUALITY.md``'s milestone
tables.

    python -m keras_nerf_tpu_torch.extract_milestones RUN_LOG
        [--thresholds 25 28 30 31] [--device cuda]

Reads the ``epoch N: ... val_fine_psnr=X`` lines (JAX's CLI's or the
port's, time-stamped by the logger); minutes count from the log's first
time-stamped line, on the hardware of the run that wrote it. ``--device``
takes the card as every tool of the port does; nothing here runs on it.
Prints the card's line first, a summary, one line a threshold and, last,
``{"extract_milestones": ...}``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import re

_TS_RE = re.compile(r"^(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2})")
_EPOCH_RE = re.compile(r"(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}).*epoch (\d+):.*"
                       r"val_fine_psnr=([0-9.]+)")


def _stamp(text: str) -> datetime.datetime:
    return datetime.datetime.strptime(text, "%Y-%m-%d %H:%M:%S")


def epoch_rows(path: str) -> list[tuple[int, float, float]]:
    """``(epoch, val fine PSNR, minutes since the first stamped line)`` of
    every epoch line."""
    t0, rows = None, []
    with open(path) as f:
        for line in f:
            if t0 is None:
                m = _TS_RE.match(line)
                if m:
                    t0 = _stamp(m.group(1))
            m = _EPOCH_RE.search(line)
            if m:
                minutes = (_stamp(m.group(1)) - t0).total_seconds() / 60.0
                rows.append((int(m.group(2)), float(m.group(3)), minutes))
    return rows


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log")
    ap.add_argument("--thresholds", type=float, nargs="*",
                    default=[25.0, 28.0, 30.0, 31.0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    from keras_nerf_tpu_torch import timing

    args = build_arg_parser().parse_args(argv)
    timing.start(args.device)
    rows = epoch_rows(args.log)
    if not rows:
        raise SystemExit("no epoch lines found")
    best = max(rows, key=lambda r: r[1])
    print(f"{len(rows)} epochs parsed; last epoch {rows[-1][0]} "
          f"val_fine {rows[-1][1]:.2f} dB at {rows[-1][2]:.1f} min; "
          f"best {best[1]:.2f} dB @ epoch {best[0]}", flush=True)
    hits = {}
    for thr in args.thresholds:
        hit = next((r for r in rows if r[1] >= thr), None)
        hits[str(thr)] = None if hit is None else {"epoch": hit[0],
                                                   "minutes": hit[2]}
        if hit:
            print(f">= {thr:4.1f} dB: epoch {hit[0]:3d}  {hit[2]:6.1f} min",
                  flush=True)
        else:
            print(f">= {thr:4.1f} dB: not reached", flush=True)
    out = {"epochs": len(rows), "best": {"epoch": best[0], "psnr": best[1]},
           "milestones": hits}
    print(json.dumps({"extract_milestones": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
