"""The quality record of a training run from its log: the PSNR-against-epoch
curve and the milestone table (epochs and wall-clock minutes to 25 / 28 /
30 dB val fine PSNR), as ``docs/QUALITY.md`` builds them (port of
``scripts/plot_quality.py``).

    python -m keras_nerf_tpu_torch.plot_quality LOG_CSV [--run_log LOG]
        [--out_png assets/quality128_psnr_torch.png] [--title TEXT]
        [--device cuda]

The metrics come from the run log's ``epoch N:`` lines (one an epoch, with
the logger's time stamps), else from ``log.csv`` (a row every
``update_freq`` epochs, no time). Both CLIs, JAX's and the port's, write
the same lines. The curve is drawn only where matplotlib imports (the
card's machine has none): otherwise the tool says so and still prints the
table. The minutes are those of the run that wrote the log, on its
hardware. ``--device`` takes the card as every tool of the port does;
nothing here runs on it. Prints the card's line first, then the table, the
best epoch and, last, ``{"plot_quality": ...}``.
"""

from __future__ import annotations

import argparse
import csv
import json
import re
from datetime import datetime

# The repo's series colours (utils/monitor.py): blue coarse, orange fine;
# solid train, dashed val.
BLUE, ORANGE, GRAY = "#1f77b4", "#ff7f0e", "#777777"

_EPOCH_RE = re.compile(
    r"(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}),\d+ \| root \| INFO \| "
    r"epoch (\d+):")
_METRIC_RE = re.compile(r"(\w+)=([0-9.]+)")


def read_log_csv(path: str) -> dict[str, list[float]]:
    cols: dict[str, list[float]] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                cols.setdefault(k, []).append(float(v))
    return cols


def read_run_log(run_log: str):
    """``(cols, times)``: the ``epoch N:`` lines' metrics as columns keyed
    like ``log.csv`` (one row an epoch), and ``{epoch: seconds since the
    first epoch line}``; ``({}, {})`` when the log has no such line."""
    stamps: dict[int, datetime] = {}
    metrics: dict[int, dict[str, float]] = {}
    with open(run_log, errors="replace") as f:
        for line in f:
            m = _EPOCH_RE.search(line)
            if not m:
                continue
            epoch = int(m.group(2))
            stamps[epoch] = datetime.strptime(m.group(1),
                                              "%Y-%m-%d %H:%M:%S")
            metrics[epoch] = {k: float(v) for k, v in
                              _METRIC_RE.findall(line[m.end():])}
    if not stamps:
        return {}, {}
    t0 = min(stamps.values())
    times = {e: (t - t0).total_seconds() for e, t in stamps.items()}
    epochs = sorted(metrics)
    cols = {"epoch": [float(e) for e in epochs]}
    for k in metrics[epochs[0]]:
        cols[k] = [metrics[e][k] for e in epochs]
    return cols, times


def milestone_table(epochs, val_psnr, times: dict[int, float],
                    thresholds=(25.0, 28.0, 30.0)) -> list[dict]:
    """For each threshold, the first epoch whose val PSNR reaches it and
    its minutes (None where not reached, or without times)."""
    rows = []
    for thr in thresholds:
        hit = next((i for i, p in enumerate(val_psnr) if p >= thr), None)
        if hit is None:
            rows.append({"threshold": thr, "epoch": None, "minutes": None})
            continue
        e = int(epochs[hit])
        rows.append({"threshold": thr, "epoch": e,
                     "minutes": times.get(e, 0.0) / 60.0 if times else None})
    return rows


def table_lines(rows: list[dict]) -> list[str]:
    lines = ["| val fine PSNR | epoch | wall-clock (min, the log's run) |",
             "|---|---|---|"]
    for r in rows:
        if r["epoch"] is None:
            lines.append(f"| ≥{r['threshold']:.0f} dB | not reached | — |")
        else:
            mins = (f"{r['minutes']:.1f}" if r["minutes"] is not None
                    else "n/a")
            lines.append(f"| ≥{r['threshold']:.0f} dB | {r['epoch']} | "
                         f"{mins} |")
    return lines


def plot(cols: dict, out_png: str, title: str) -> bool:
    """The four PSNR curves against epoch into ``out_png``, where
    matplotlib imports; False (and a line saying so) where it does not."""
    try:
        import matplotlib
    except ImportError:
        print("plot skipped: matplotlib is not installed", flush=True)
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = cols["epoch"]
    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=150)
    for key, color, style, label in (
            ("coarse_psnr", BLUE, "-", "coarse train"),
            ("val_coarse_psnr", BLUE, "--", "coarse val"),
            ("fine_psnr", ORANGE, "-", "fine train"),
            ("val_fine_psnr", ORANGE, "--", "fine val")):
        ax.plot(epochs, cols[key], color=color, lw=2, linestyle=style,
                label=label)
    ax.axhline(30.0, color=GRAY, lw=1, linestyle=":")
    ax.annotate("30 dB north star", (epochs[0], 30.0),
                textcoords="offset points", xytext=(4, 4), color=GRAY,
                fontsize=9)
    ax.set_xlabel("epoch")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(f"PSNR vs epoch — {title}")
    ax.spines[["top", "right"]].set_visible(False)
    ax.grid(axis="y", alpha=0.25)
    ax.legend(frameon=False, loc="lower right")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    print(f"wrote {out_png}", flush=True)
    return True


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_csv")
    ap.add_argument("--run_log", default="")
    ap.add_argument("--out_png", default="assets/quality128_psnr_torch.png")
    ap.add_argument("--title", default="synthetic scene 128x128")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    from keras_nerf_tpu_torch import timing

    args = build_arg_parser().parse_args(argv)
    timing.start(args.device)
    cols: dict[str, list[float]] = {}
    times: dict[int, float] = {}
    if args.run_log:
        cols, times = read_run_log(args.run_log)
    if not cols:
        cols = read_log_csv(args.log_csv)
    drawn = plot(cols, args.out_png, args.title)
    epochs, val = cols["epoch"], cols["val_fine_psnr"]
    rows = milestone_table(epochs, val, times)
    print("\n" + "\n".join(table_lines(rows)), flush=True)
    best = max(val)
    ep_best = int(epochs[val.index(best)])
    t_best = times.get(ep_best)
    print(f"\nbest val fine PSNR: {best:.2f} dB at epoch {ep_best}"
          + (f" ({t_best / 60:.1f} min)" if t_best is not None else ""),
          flush=True)
    out = {"rows": rows, "best_val_fine_psnr": best, "best_epoch": ep_best,
           "png": args.out_png if drawn else None}
    print(json.dumps({"plot_quality": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
