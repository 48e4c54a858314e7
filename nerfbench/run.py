"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python -m nerfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds every number the output
check compared beside its limit, which are also the last lines of
standard error. Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from nerfbench import harness  # noqa: E402


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    one host thread for PyTorch's and OpenMP's CPU work, so that the run is
    one process's load on a host it shares with others."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    build = harness.ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def _number(x):
    return x if x is None or math.isfinite(x) else None


def result_line(cell: harness.Cell, out: harness.Outcome, setup_s: float,
                trace: bool, device) -> tuple[dict, bool]:
    import torch

    correct, checks = harness.verdict(out.readings, cell.checks["limits"])
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.layer_reader(m["name"])(out.stretch)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # A metric named <quantity>.<cells> reports the driver's
        # <quantity> under a bound of its own.
        values = dict(out.end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    if trace:
        dev.update(busy_s=out.busy_s, window_s=out.window_s)
    # Every step or frame of the closed loop finishes before the next
    # starts, or the run ends with an error: none fails alone.
    line = {"correct": correct and out.attempted > 0,
            "attempted": out.attempted, "failed": 0,
            "metrics": metrics, "device": dev}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                      for k, v in checks.items()}
    return line, line["correct"]


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    _environment()
    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

    if device is None:
        if not torch.cuda.is_available():
            print("nerfbench: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"nerfbench: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    out = harness.driver(cell.traffic["kind"]).run(
        cell, args.seed, args.seconds, bool(args.trace), device)
    found = harness.forbidden_modules()
    if found:
        print(f"nerfbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    line, _ = result_line(cell, out, out.window_start - T_START,
                          bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
