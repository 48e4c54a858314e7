"""Time the ``ray_march_quadrature`` kernel on the card, in turns against
another build of its source, beside the launch floor.

    python -m keras_nerf_tpu_torch.time_quadrature [--parent DIR] \\
        [--iters 200] [--out FILE]

``DIR`` is the ``keras_nerf_tpu_torch/kernels/csrc`` directory of another
checkout (the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) whose entry points take this tree's arguments:
its ``ray_march_quadrature.cu`` is compiled alone, with this package's
``nvcc`` flags, and launched through this package's wrapper.

At the shapes of the paths (:data:`SHAPES`): the MSE step's with_grad
launches [2048 x 64] (with the weights) and [2048 x 192], the fine pass of
1024 draws [2048 x 1088] (ROADMAP C14: past the parent's 1024 samples, so
this tree alone), the render's sigma-only coarse pass [4096 x 64] (with
the weights), the occupancy frame's [4096 x 64] and the render's fine pass
[4096 x 192] (no weights), white background, from a seed. Each build is
first held against the plain version (largest absolute error of image,
depth and weights; relative max of the bf16 cotangents) and run twice
(identical bits or not), this tree's also against the parent's (identical
bits or not); then, in turns, parent, this tree, this tree, parent: device
ms per launch by CUDA events over ``iters`` launches, with a spin kernel
holding the stream while the host enqueues them
(``time_mlp_backward.time_ms``, as ``chip_smoke.py`` times). This tree's
kernel at every block shape (:data:`RAYS_PER_BLOCK`) follows. With a
parent, the with_grad mode at every S of :data:`PARENT_S` (up to the
parent's 1024) is held against the parent's bits on 300 rays, both
backgrounds. The launch floor is ``torch.cuda._sleep(0)`` timed the same
way, before and after the turns.

The card's name and power limit, and its clocks before and after, come from
``nvidia-smi``; the registers and spills of every instantiation of both
builds from ``-Xptxas -v``. Prints one line per turn and the whole as JSON
(also to ``FILE``). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.time_mlp_backward import _smi, time_ms

# label: (rays, samples, mode, emit_weights)
SHAPES = {
    "with_grad coarse [2048 x 64]": (2048, 64, "with_grad", True),
    "with_grad fine [2048 x 192]": (2048, 192, "with_grad", False),
    "with_grad fine [2048 x 1088]": (2048, 1088, "with_grad", False),
    "sigma-only [4096 x 64]": (4096, 64, "sigma_only", True),
    "no weights [4096 x 64]": (4096, 64, "full", False),
    "full, no weights [4096 x 192]": (4096, 192, "full", False),
}
RAYS_PER_BLOCK = (1, 2, 4, 8, 16)
ENTRY_POINTS = ("knt_ray_march_quadrature", "knt_ray_march_quadrature_grad")
# The with_grad mode's sample counts held against the parent's bits: both
# routes, their edges, and every window count up to the parent's four.
PARENT_S = (1, 31, 32, 33, 192, 256, 257, 512, 513, 700, 768, 1000, 1024)
PARENT_MAX_S = 1024


def make_inputs(rays, s, mode, device, seed=0):
    """``(args, kwargs)`` of one call on ``device`` from a seed: sorted
    depths in [2, 6], uniform colours, densities in [0, 5) (sigma alone in
    sigma-only mode), white background, and with_grad a target."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.sort(torch.rand(rays, s, generator=g, device=device) * 4 + 2,
                   dim=-1).values
    rgbs = torch.rand(rays, s, 4, generator=g, device=device)
    rgbs[..., 3] *= 5
    sigma_only = mode == "sigma_only"
    kw = {}
    if mode == "with_grad":
        kw = dict(target=torch.rand(rays, 3, generator=g, device=device),
                  loss_scale=2.0 / (3 * rays))
    inp = rgbs[..., 3].contiguous() if sigma_only else rgbs
    return (inp, t, True, sigma_only), kw


def _parent_lib(parent: Path):
    """The parent's source built alone, its entry points declared as this
    package declares them, and what the compiler printed."""
    out_dir = _build.BUILD_ROOT.parent / "parent_quadrature"
    lib = _build.build_single(parent / "ray_march_quadrature.cu", out_dir,
                              ENTRY_POINTS)
    return lib, (out_dir / "build.log").read_text()


def _same_bits(got, want) -> bool:
    return all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, want))


def ptxas_table(log: str) -> dict:
    """Kernel -> registers and spill bytes from ``-Xptxas -v`` output,
    names demangled by ``cu++filt`` where the toolkit has it."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            table[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                table[name]["spill_stores"] = int(m.group(1))
                table[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                table[name]["registers"] = int(m.group(1))
    filt = shutil.which("cu++filt") if table else None
    if table and filt is None:
        near = Path(_build.find_nvcc()).parent / "cu++filt"
        filt = str(near) if near.exists() else None
    if filt is not None:
        names = subprocess.run([filt], input="\n".join(table),
                               capture_output=True,
                               text=True).stdout.splitlines()
        if len(names) == len(table):
            table = dict(zip(names, table.values()))
    return {k: v for k, v in table.items() if "quadrature" in k}


def _section(log: str, source: str) -> str:
    """The part of a multi-source build log that one source printed."""
    parts = re.split(r"^== (\S+)$", log, flags=re.M)
    return "".join(text for name, text in zip(parts[1::2], parts[2::2])
                   if name == source)


def _errors(got, want) -> dict:
    floats = max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3])
                 if b is not None)
    out = {"abs_max": floats}
    if len(want) > 3:
        out["cotangents_rel_max"] = max(
            float((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp_min(1e-30))
            for a, b in zip(got[3:], want[3:]))
    return out


def measure(parent: Path | None = None, iters: int = 200) -> dict:
    """The checks and turns at every shape; see the module's text."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_quadrature needs an NVIDIA card")
    dev = torch.device("cuda")
    _build.load()
    out = {"card": _smi("name,power.limit"), "turns": {}, "errors": {},
           "rays_per_block": {},
           "ptxas": {"new": ptxas_table(_section(
               _build.last_build().log, "ray_march_quadrature.cu"))}}
    lib = None
    if parent is not None:
        lib, log = _parent_lib(parent)
        out["ptxas"]["parent"] = ptxas_table(log)
    for build, table in out["ptxas"].items():
        for name, v in table.items():
            print(f"ptxas {build} {name}: {v}", flush=True)
    q = "clocks.sm,power.draw,power.limit,temperature.gpu"
    out["clocks"] = [{"when": "before the turns", q: _smi(q)}]
    out["launch_floor_ms"] = [time_ms(lambda: torch.cuda._sleep(0), iters)]
    print(f"launch floor: {out['launch_floor_ms'][0]:.4f} ms/launch",
          flush=True)
    for key, (rays, s, mode, emit) in SHAPES.items():
        args, kw = make_inputs(rays, s, mode, dev)
        builds = {"new": lambda: trm._ray_march_quadrature_cuda(
            *args, emit, **kw)}
        if lib is not None and (mode != "with_grad" or s <= PARENT_MAX_S):
            builds["parent"] = lambda: trm._ray_march_quadrature_cuda(
                *args, emit, lib=lib, **kw)
        want = trm.ray_march_quadrature_plain(*args, emit, **kw)
        outs = {}
        for label, fn in builds.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            outs[label] = got
            out["errors"][f"{key} {label}"] = {
                **_errors(got, want), "identical_twice": _same_bits(got,
                                                                    again)}
        if "parent" in outs:
            out["errors"][f"{key} new"]["identical_to_parent"] = _same_bits(
                outs["new"], outs["parent"])
        for label, e in out["errors"].items():
            if label.startswith(key):
                print(f"check {label}: {e}", flush=True)
        order = (["parent", "new", "new", "parent"] if "parent" in builds
                 else ["new", "new"])
        times = []
        for label in order:
            ms = time_ms(builds[label], iters)
            times.append((label, ms))
            print(f"turn {key} {label}: {ms:.4f} ms/launch", flush=True)
        out["turns"][key] = times
        out["rays_per_block"][key] = {}
        for rpb in RAYS_PER_BLOCK:
            ms = time_ms(lambda: trm._ray_march_quadrature_cuda(
                *args, emit, rays_per_block=rpb, **kw), iters)
            out["rays_per_block"][key][rpb] = ms
            print(f"block shape {key}: {rpb} rays a block {ms:.4f} "
                  f"ms/launch", flush=True)
    if lib is not None:
        out["parent_bits"] = {}
        for s in PARENT_S:
            for white in (True, False):
                args, kw = make_inputs(300, s, "with_grad", dev, seed=s)
                args = (args[0], args[1], white, False)
                same = _same_bits(
                    trm._ray_march_quadrature_cuda(*args, True, **kw),
                    trm._ray_march_quadrature_cuda(*args, True, lib=lib,
                                                   **kw))
                out["parent_bits"][f"with_grad S={s} white={white}"] = same
        print(f"with_grad identical to the parent's bits at S in {PARENT_S}"
              f", both backgrounds: {all(out['parent_bits'].values())}",
              flush=True)
    out["launch_floor_ms"].append(time_ms(lambda: torch.cuda._sleep(0),
                                          iters))
    out["clocks"].append({"when": "after the turns", q: _smi(q)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="kernels/csrc directory of another checkout")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    text = json.dumps(measure(args.parent, args.iters))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
