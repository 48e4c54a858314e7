"""Time the ``sample_merge`` kernel on the card, in turns against another
build of its source, beside the launch floor.

    python -m keras_nerf_tpu_torch.time_sample_merge [--parent DIR] \\
        [--iters 200] [--out FILE]

``DIR`` is the ``keras_nerf_tpu_torch/kernels/csrc`` directory of another
checkout (the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists): its ``sample_merge.cu`` is compiled alone, with
this package's ``nvcc`` flags, and launched through this package's wrapper
(:class:`ParentEntry` adapts the entry point of a build that takes no row
stride of the CDF source and no plan; it is handed a contiguous source).

At the shapes of the paths (:data:`SHAPES`): the render chunk's fine pass
[4096, 64 + 128], the training chunk's [2048, 64 + 128], the occupancy
render's no-merge draws [4096, 64 bins -> 64] (this tree reads the probe
bins as one row, as the path hands them over; the parent, whose path
copied them to every ray first, a copy) and the partner mode [4096, 64
bins, 64 + 64]. Each build is first held against the plain version
(largest absolute error, bit for bit or not); then, in turns, parent, this
tree, this tree, parent: device ms per launch by CUDA events over
``iters`` launches, with a spin kernel holding the stream while the host
enqueues them (``time_mlp_backward.time_ms``, as ``chip_smoke.py`` times).
The launch floor is ``torch.cuda._sleep(0)`` timed the same way, before
and after the turns; the per-chunk copy of the probe bins that the
occupancy path no longer makes is timed beside it.

With ``--parent`` it also renders one 128^2 frame of a seeded fog model
(8 x 256, sigma bias +1, as ``chip_smoke.py``) through the bf16 kernels
with each build's fine depths on the same rays and draws, and prints how
far the image and depth move between the two CDF definitions. The card's
name and power limit, and its clocks before and after, come from
``nvidia-smi``. Prints one line per turn and the whole as JSON (also to
``FILE``). Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.ops import sorted_uniforms
from keras_nerf_tpu_torch.time_mlp_backward import _smi, time_ms

# label: (rays, bins, draws, partner: "bins" (the fine pass), None or a
# width, weights: "cubed" or "occupancy")
SHAPES = {
    "render [4096, 64 + 128]": (4096, 64, 128, "bins", "cubed"),
    "train [2048, 64 + 128]": (2048, 64, 128, "bins", "cubed"),
    "occupancy no merge [4096, 64 -> 64]": (4096, 64, 64, None, "occupancy"),
    "partner [4096, 64, 64 + 64]": (4096, 64, 64, 64, "occupancy"),
}


class ParentEntry:
    """A build of ``sample_merge.cu`` whose ``knt_sample_merge`` takes
    ``(cp, w, u, mp, out, rays, s_c, n, s_m, stream)``, behind this
    package's call: it reads a contiguous CDF source only and sizes its own
    launch."""

    def __init__(self, lib: ctypes.CDLL):
        P, I = ctypes.c_void_p, ctypes.c_int
        self._fn = lib.knt_sample_merge
        self._fn.argtypes = [P, P, P, P, P, I, I, I, I, P]
        self._fn.restype = I

    def knt_sample_merge(self, cp, cp_stride, w, u, mp, out, rays, s_c, n,
                         s_m, rays_per_block, smem, stream):
        if cp_stride != s_c:
            raise ValueError("the parent's build reads a contiguous CDF "
                             "source only")
        return self._fn(cp, w, u, mp, out, rays, s_c, n, s_m, stream)


def make_inputs(rays, s_c, n, partner, weights, device, seed=0):
    """``(cp, w, u, mp)`` on ``device`` from a seed: sorted depths in [2,
    6] (the probe bins: one row broadcast to every ray), cubed uniform or
    0/1 weights with every fifth ray empty, sorted draws, and the partner
    (the bins themselves, None or sorted depths)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def depths(r, s):
        return torch.sort(torch.rand(r, s, generator=g, device=device) * 4
                          + 2, dim=-1).values

    if weights == "cubed":
        cp = depths(rays, s_c)
        w = torch.rand(rays, s_c, generator=g, device=device) ** 3
    else:
        cp = depths(1, s_c).expand(rays, s_c)
        w = (torch.rand(rays, s_c, generator=g, device=device) > 0.6).float()
        w[::5] = 0.0
    u = sorted_uniforms(g, (rays,), n)
    mp = cp if partner == "bins" else (
        None if partner is None else depths(rays, partner))
    return cp, w, u, mp


def _frame_moved(parent) -> dict:
    """One 128^2 fog frame through the bf16 kernels, fine depths from this
    tree's build and from ``parent`` on the same rays and draws: the
    largest change of image and depth."""
    from keras_nerf_tpu_torch.data import (
        generate_ray_batch,
        get_focal_from_fov,
        pose_spherical,
    )
    from keras_nerf_tpu_torch.inference import ORBIT
    from keras_nerf_tpu_torch.models import NeRF

    img = 128
    nerf = NeRF().compile(batch_size=1, image_height=img, image_width=img,
                          ray_chunks=4096, white_background=True,
                          device="cuda", seed=0)
    for p in (nerf.coarse_params, nerf.fine_params):
        p["sigma"]["bias"] += 1.0
    g = torch.Generator(device="cuda").manual_seed(42)
    rays = generate_ray_batch(
        pose_spherical(0.0, ORBIT["phi"], ORBIT["z_translate"])[None], g,
        image_height=img, image_width=img,
        focal=get_focal_from_fov(ORBIT["fov"], img), near=ORBIT["near"],
        far=ORBIT["far"], n_samples=nerf.config.n_coarse)
    frames = {}
    launch = trm.sample_merge._launch
    for label, lib in (("new", None), ("parent", parent)):
        trm.sample_merge._launch = (
            lambda *a, lib=lib: trm._sample_merge_cuda(*a, lib=lib))
        try:
            _, fine = nerf.predict_and_render_images(
                rays, with_weights=False, coarse_image=False,
                fine_draws=torch.Generator(device="cuda").manual_seed(1))
        finally:
            trm.sample_merge._launch = launch
        frames[label] = fine
    return {k: float((frames["new"][k] - frames["parent"][k]).abs().max())
            for k in ("image", "depth")}


def measure(parent: Path | None = None, iters: int = 200) -> dict:
    """The checks and turns at every shape; see the module's text."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_sample_merge needs an NVIDIA card")
    dev = torch.device("cuda")
    lib = None if parent is None else ParentEntry(_build.build_single(
        parent / "sample_merge.cu",
        _build.BUILD_ROOT.parent / "parent_sample_merge", ()))
    q = "clocks.sm,power.draw,power.limit,temperature.gpu"
    out = {"card": _smi("name,power.limit"),
           "clocks": [{"when": "before the turns", q: _smi(q)}],
           "launch_floor_ms": [time_ms(lambda: torch.cuda._sleep(0), iters)],
           "turns": {}, "errors": {}}
    print(f"launch floor: {out['launch_floor_ms'][0]:.4f} ms/launch",
          flush=True)
    for key, shape in SHAPES.items():
        cp, w, u, mp = make_inputs(*shape, dev)
        builds = {"new": lambda: trm._sample_merge_cuda(cp, w, u, mp)}
        if lib is not None:
            cp_rows = cp.contiguous()
            mp_rows = cp_rows if shape[3] == "bins" else mp
            builds["parent"] = lambda: trm._sample_merge_cuda(
                cp_rows, w, u, mp_rows, lib=lib)
        want = trm.sample_merge_plain(cp, w, u, mp)
        for label, fn in builds.items():
            got = fn()
            torch.cuda.synchronize()
            out["errors"][f"{key} {label}"] = {
                "abs_max": float((got - want).abs().max()),
                "bit_equal": bool(torch.equal(got, want))}
        order = (["parent", "new", "new", "parent"] if lib is not None
                 else ["new", "new"])
        times = []
        for label in order:
            ms = time_ms(builds[label], iters)
            times.append((label, ms))
            print(f"turn {key} {label}: {ms:.4f} ms/launch", flush=True)
        out["turns"][key] = times
        if shape[4] == "occupancy" and shape[3] is None:
            out["probe_bin_copy_ms"] = time_ms(cp.contiguous, iters)
    out["launch_floor_ms"].append(time_ms(lambda: torch.cuda._sleep(0),
                                          iters))
    if lib is not None:
        out["frame_moved"] = _frame_moved(lib)
        print(f"128^2 fog frame, fine depths of this build against the "
              f"parent's: {out['frame_moved']}", flush=True)
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
