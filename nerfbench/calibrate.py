"""The readings that the output check's limits are set from, at a cell's
own size, in one process:

    python -m nerfbench.calibrate --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 [--out FILE]

For each of ``--seeds``: the program's sound readings, as a run takes them
(training: the checked steps against the reference; rendering: the frames
a run samples, here drawn from the orbit's poses). For each of
``--control-seeds`` the program's sound readings too, and then the
controls' and the planted faults'. Training: the reference in float8
operands in the program's place (the control), half of each batch left
out with the mean taken over the rest, Adam's learning rate 1.2 times the
configuration's, and Adam's ``(b1, b2)`` at (0.8, 0.99) for (0.9, 0.999). Rendering: the program's own int8 render tier (the
control) on the same frames or, with ``--fp8``, the reference in float8
operands. The
benchmark's runs never run this. One JSON line a reading, then a summary:
the largest sound reading (the lower) and the smallest of each control's
or fault's (the upper) per number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nerfbench import clock, harness
from nerfbench.traffic import render, train


def _train(cell, seed, device, control: bool) -> list[tuple[str, dict]]:
    s = train.setup(cell.config, cell.traffic, seed, device)
    prog = train.check_steps(s, cell.checks["check_steps"])
    s.model = s.dataset = None
    clock.free(device)
    ref32 = train.reference_steps(s, prog)
    readings = train.data_checks(s, prog)
    readings.update(train.gaps(train.program_side(prog), ref32))
    readings["losses"] = [list(x) for x in prog.losses]
    readings["ref_losses"] = [list(x) for x in ref32["losses"]]
    out = [("program", readings)]
    if control:
        for kind, kwargs in (("control_fp8", {"precision": "fp8"}),
                             ("fault_half_batch", {"keep_share": 0.5}),
                             ("fault_lr_1.2", {"lr_scale": 1.2}),
                             ("fault_betas_0.8_0.99",
                              {"betas": (0.8, 0.99)})):
            out.append((kind, train.gaps(
                train.reference_steps(s, prog, **kwargs), ref32)))
    return out


def _render(cell, seed, device, control: bool,
            fp8: bool = False) -> list[tuple[str, dict]]:
    cfg = cell.config
    tiers = (False, True) if control and not fp8 else (False,)
    out, refs = [], None
    for quantized in tiers:
        model, weights, poses = render.setup(cfg, cell.traffic, seed, device,
                                             quantized=quantized)
        picked = render.sample(seed, len(poses), cell.checks["sample_frames"])
        frames = [(p, render.render_frame(model, poses[p])) for p in picked]
        del model
        clock.free(device)
        if refs is None:
            refs = render.reference_frames(cfg, weights, poses, picked)
        kind = "control_int8" if quantized else "program"
        out.append((kind, render.gaps(frames, refs, lambda i: i)))
    if control and fp8:
        low = render.reference_frames(cfg, weights, poses, picked, "fp8")
        out.append(("control_fp8", render.gaps(list(low.items()), refs,
                                               lambda i: i)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fp8", action="store_true",
                   help="rendering: the reference in float8 operands as the "
                        "control, in place of the int8 tier")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("nerfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if cell.traffic["kind"] == "train":
        fn = _train
    else:
        def fn(cell, seed, device, control):
            return _render(cell, seed, device, control, args.fp8)
    rows = []
    sink = open(args.out, "w") if args.out else None
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            for kind, readings in fn(cell, seed, device, control):
                row = {"cell": cell.name, "kind": kind, "seed": seed,
                       "seconds": time.perf_counter() - t, **readings}
                rows.append(row)
                print(json.dumps(row), flush=True)
                if sink:
                    sink.write(json.dumps(row) + "\n")
                    sink.flush()
    summary = {"cell": cell.name, "lower": {}, "upper": {}}
    for row in rows:
        for k, v in row.items():
            if not isinstance(v, float) or k == "seconds":
                continue
            if row["kind"] == "program":
                summary["lower"][k] = max(summary["lower"].get(k, 0.0), v)
            else:
                key = f"{k}.{row['kind']}"
                summary["upper"][key] = min(summary["upper"].get(key, v), v)
    print(json.dumps(summary), flush=True)
    if sink:
        sink.write(json.dumps(summary) + "\n")
        sink.close()
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
