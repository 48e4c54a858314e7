"""Val PSNR against wall-clock minutes for several training runs, from
their run logs (port of ``scripts/plot_compare.py``).

    python -m keras_nerf_tpu_torch.plot_compare OUT_PNG label1=run1.log
        [label2=run2.log ...] [--device cuda]

Each log is a training CLI's output (the ``epoch N:`` lines that
``plot_quality.read_run_log`` reads, JAX's CLI's or the port's). The
curves are drawn only where matplotlib imports (the card's machine has
none); either way each run's milestone table is printed. ``--device``
takes the card as every tool of the port does; nothing here runs on it.
Prints the card's line first and, last, ``{"plot_compare": ...}``.
"""

from __future__ import annotations

import argparse
import json

from keras_nerf_tpu_torch.plot_quality import (milestone_table, read_run_log,
                                               table_lines)

# Blue and orange first (the monitor's pair), then Okabe-Ito green.
COLORS = ["#1f77b4", "#ff7f0e", "#009e73", "#777777"]


def plot(runs: dict, out_png: str) -> bool:
    """``runs``: ``{label: (cols, times)}``. False where matplotlib is
    missing (and a line saying so)."""
    try:
        import matplotlib
    except ImportError:
        print("plot skipped: matplotlib is not installed", flush=True)
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=150)
    for (label, (cols, times)), color in zip(runs.items(), COLORS):
        minutes = [times[int(e)] / 60.0 for e in cols["epoch"]]
        ax.plot(minutes, cols["val_fine_psnr"], color=color, lw=2,
                label=label)
    ax.axhline(30.0, color="#777777", lw=1, linestyle=":")
    ax.annotate("30 dB north star", (0, 30.0), textcoords="offset points",
                xytext=(4, 4), color="#777777", fontsize=9)
    ax.set_xlabel("wall-clock minutes (each run's own hardware)")
    ax.set_ylabel("val fine PSNR (dB)")
    ax.set_title("Validation PSNR vs wall-clock")
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
    ap.add_argument("out_png")
    ap.add_argument("runs", nargs="+", metavar="label=run.log")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    from keras_nerf_tpu_torch import timing

    args = build_arg_parser().parse_args(argv)
    timing.start(args.device)
    runs = {}
    for arg in args.runs:
        label, path = arg.split("=", 1)
        runs[label] = read_run_log(path)
    tables = {}
    for label, (cols, times) in runs.items():
        rows = milestone_table(cols["epoch"], cols["val_fine_psnr"], times)
        tables[label] = rows
        print(f"\n{label}:\n" + "\n".join(table_lines(rows)), flush=True)
    drawn = plot(runs, args.out_png)
    out = {"milestones": tables, "png": args.out_png if drawn else None}
    print(json.dumps({"plot_compare": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
