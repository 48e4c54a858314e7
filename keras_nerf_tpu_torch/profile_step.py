"""Where the time of one training step goes (port of
``scripts/profile_step.py``).

    python -m keras_nerf_tpu_torch.profile_step [--img_wh 128]
        [--chunks 2048 4096 8192 16384] [--iters 20] [--device cuda]

On the headline step (``img_wh``^2 rays of one image, 64 + 128 samples,
8 x 256 MLPs, Adam, the fused training kernels on the card):

* ``train_step`` ms at each ``--chunks`` (CUDA events around ``--iters``
  chained steps after two warm-up steps; the host clock on the CPU);
* per component, at the first ``--chunks``: the coarse pass (its MLP and
  quadrature), ``sample_merge``, the fine pass (its MLP and quadrature),
  the backward kernels (``mlp_backward``, ``mlp_weight_grad``, both
  models), Adam (both models' updates) and the ray batch (the loader's
  image upload and ``generate_ray_batch``), each from CUDA events around
  its calls, summed over a step; ``other`` is the step's wall less their
  sum (the host's work between them);
* the host timeline of one step under ``torch.profiler``: the host clock
  at each launch onto the card (the runtime's launch, memset and copy
  calls), by the name of what it ran there, as ``chip_smoke.py`` counts
  launches; the gaps between consecutive launches, and for the longest
  ones what the host did meanwhile (the operations and ranges that overlap
  the gap most, innermost first); the launches counted by the innermost
  labelled range around each (a component, a kernel wrapper, or
  ``other``), and the time the host spent blocked on the card's full
  launch queue. On the CPU the timeline holds the kernel wrappers' calls
  instead, which run their plain versions.

Prints one line a reading and, last, one JSON object ``{"profile_step":
...}``. It wraps the kernel wrappers, ``fused_train_chunk`` and the
optimizer's update for the instrumented steps and restores them: it
measures and changes no path.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from keras_nerf_tpu_torch.timing import LAUNCH_PREFIXES, sync

COMPONENTS = ("ray batch", "coarse pass", "sample_merge", "fine pass",
              "backward kernels", "adam")
_TOP_GAPS = 5


class _Clock:
    """Paired marks on the card's stream (CUDA events) or, on the CPU, the
    host clock; :meth:`ms` after the stream is synchronized."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


def headline(device: torch.device, img_wh: int, seed: int = 0):
    """The headline step's config, Adam, a seeded state and a dataset of 4
    random images at orbit poses (the loader's path: host images, rays and
    depths made on the device)."""
    from keras_nerf_tpu_torch.data.loader import NeRFDataset
    from keras_nerf_tpu_torch.data.utils import (get_focal_from_fov,
                                                 pose_spherical)
    from keras_nerf_tpu_torch.models import engine

    cfg = engine.NeRFConfig(white_background=True)
    opt = engine.make_optimizer("adam", 1e-3)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = engine.init_train_state(gen, cfg, opt)
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(4, img_wh, img_wh, 4)).astype(np.float32)
    poses = np.stack([pose_spherical(th, -30.0, 4.0)
                      for th in (0.0, 90.0, 180.0, 270.0)])
    dataset = NeRFDataset(
        images, poses, focal=get_focal_from_fov(0.6911112070083618, img_wh),
        near=2.0, far=6.0, n_samples=cfg.n_coarse, batch_size=1,
        shuffle=True, seed=seed, device=device)
    return cfg, opt, state, dataset, gen


def step_ms(state, batch, gen, opt, cfg, chunks: int, iters: int,
            device: torch.device):
    """Mean ``train_step`` ms over ``iters`` chained steps (two warm-up
    steps first), and the state after them."""
    from keras_nerf_tpu_torch.models import engine

    for _ in range(2):
        state, _ = engine.train_step(state, batch, gen, opt, cfg, chunks)
    sync(device)
    clock = _Clock(device)
    t0 = clock.mark()
    for _ in range(iters):
        state, _ = engine.train_step(state, batch, gen, opt, cfg, chunks)
    t1 = clock.mark()
    sync(device)
    return clock.ms(t0, t1) / iters, state


class _Instrument:
    """Within ``with``: each kernel wrapper's launch (or plain call) and
    each ``fused_train_chunk`` is bracketed by clock marks and a
    ``record_function`` range and logged ``(component, name, marks)``;
    ``optimizer`` is ``opt`` with its updates logged alike. Restores the
    wrappers and ``fused_train_chunk`` on exit."""

    def __init__(self, device: torch.device, opt):
        self.clock = _Clock(device)
        self.log = []
        self._pass = "coarse pass"
        timed = self.timed

        class Timed:
            def update(self, *args, **kwargs):
                return timed("adam", "adam", opt.update, *args, **kwargs)

        self.optimizer = Timed()

    def timed(self, component: str, name: str, fn, *args, **kwargs):
        with torch.profiler.record_function(name):
            a = self.clock.mark()
            out = fn(*args, **kwargs)
            b = self.clock.mark()
        self.log.append((component, name, a, b))
        return out

    def __enter__(self):
        from keras_nerf_tpu_torch.kernels import KERNELS
        from keras_nerf_tpu_torch.models import engine

        self._saved = [(k, k.plain, k._launch) for k in KERNELS]
        self._chunk = engine.fused_train_chunk

        def component(name):
            if name in ("mlp_backward", "mlp_weight_grad"):
                return "backward kernels"
            return "sample_merge" if name == "sample_merge" else self._pass

        def wrap(name, fn):
            return lambda *a, **kw: self.timed(component(name), name, fn,
                                               *a, **kw)

        for k, plain, launch in self._saved:
            k.plain, k._launch = wrap(k.name, plain), wrap(k.name, launch)

        def chunk(*args, **kwargs):
            self._pass = ("coarse pass" if kwargs.get("sample_inputs") is None
                          else "fine pass")
            with torch.profiler.record_function(self._pass):
                return self._chunk(*args, **kwargs)

        engine.fused_train_chunk = chunk
        return self

    def __exit__(self, *exc):
        from keras_nerf_tpu_torch.models import engine

        for k, plain, launch in self._saved:
            k.plain, k._launch = plain, launch
        engine.fused_train_chunk = self._chunk
        return False


def instrumented_step(state, dataset, gen, opt, cfg, chunks: int,
                      device: torch.device, iters: int = 1):
    """Component ms per step (mean over ``iters`` steps) and the state."""
    from keras_nerf_tpu_torch.models import engine

    totals = dict.fromkeys(COMPONENTS, 0.0)
    walls = []
    with _Instrument(device, opt) as ins:
        for _ in range(iters):
            sync(device)
            start = ins.clock.mark()
            batch = ins.timed("ray batch", "ray batch", next, iter(dataset))
            state, _ = engine.train_step(state, batch, gen, ins.optimizer,
                                         cfg, chunks)
            end = ins.clock.mark()
            sync(device)
            walls.append(ins.clock.ms(start, end))
    for comp, _, a, b in ins.log:
        totals[comp] += ins.clock.ms(a, b) / iters
    wall = float(np.mean(walls))
    totals["other"] = wall - sum(totals.values())
    return totals, wall, state


def _trimmed(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0][:60]


def host_timeline(state, dataset, gen, opt, cfg, chunks: int,
                  device: torch.device) -> dict:
    """One step under ``torch.profiler``: its launches on the host's clock,
    the gaps between them and, for the ``_TOP_GAPS`` longest, what the host
    ran meanwhile."""
    from keras_nerf_tpu_torch.kernels import KERNELS
    from keras_nerf_tpu_torch.models import engine

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with _Instrument(device, opt) as ins:
        sync(device)
        with torch.profiler.profile(activities=acts) as prof:
            batch = ins.timed("ray batch", "ray batch", next, iter(dataset))
            engine.train_step(state, batch, gen, ins.optimizer, cfg, chunks)
            sync(device)
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    kernels = {k.name for k in KERNELS}
    if device.type == "cuda":
        on_card = {ev.id: _trimmed(ev.name) for ev in events
                   if ev.device_type != cpu and not ev.is_user_annotation}
        launches = sorted(
            (ev.time_range.start, on_card.get(ev.id, ev.name))
            for ev in events if ev.device_type == cpu
            and ev.name.startswith(LAUNCH_PREFIXES))
    else:
        # No card: the kernel wrappers' ranges, each a plain-version call.
        launches = sorted((ev.time_range.start, ev.name) for ev in events
                          if ev.device_type == cpu and ev.name in kernels)
    host_ops = [ev for ev in events if ev.device_type == cpu
                and not ev.name.startswith(LAUNCH_PREFIXES)]
    gaps = sorted(((t1 - t0, a, b, t0, t1) for (t0, a), (t1, b)
                   in zip(launches, launches[1:])), key=lambda g: -g[0])
    longest = []
    for gap, after, before, lo, hi in gaps[:_TOP_GAPS]:
        overlap = {}
        for ev in host_ops:
            s, e = ev.time_range.start, ev.time_range.end
            cover = min(e, hi) - max(s, lo)
            if cover > 0:
                total, inner = overlap.get(ev.name, (0.0, float("inf")))
                overlap[ev.name] = (total + cover, min(inner, e - s))
        # The most of the gap first; of equal cover, the innermost range.
        host = sorted(overlap.items(), key=lambda kv: (-kv[1][0], kv[1][1]))
        longest.append({"gap_ms": gap / 1e3, "after": after,
                        "before": before, "host": [
                            {"name": n, "ms": c / 1e3}
                            for n, (c, _) in host[:4]]})
    # Each launch by the innermost of the step's labelled ranges around it
    # (a component or a kernel wrapper), "other" outside them all.
    labels = {*COMPONENTS, *kernels}
    ranges = [(ev.time_range.start, ev.time_range.end, ev.name)
              for ev in host_ops if ev.name in labels]
    names, by_range = {}, {}
    for t, name in launches:
        names[name] = names.get(name, 0) + 1
        inside = [(e - s, label) for s, e, label in ranges if s <= t <= e]
        label = min(inside)[1] if inside else "other"
        by_range[label] = by_range.get(label, 0) + 1
    span = (launches[-1][0] - launches[0][0]) / 1e3 if launches else 0.0
    # The host blocked on the card's full launch queue: the card was behind.
    full = sum(ev.time_range.end - ev.time_range.start for ev in host_ops
               if ev.name == "Command Buffer Full") / 1e3
    return {"launches": len(launches), "launches_by_name": names,
            "launches_by_range": by_range, "first_to_last_launch_ms": span,
            "queue_full_ms": full, "longest_gaps": longest}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--img_wh", type=int, default=128)
    p.add_argument("--chunks", type=int, nargs="*",
                   default=[2048, 4096, 8192, 16384])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Runs the readings, prints them and returns the JSON object's
    ``profile_step`` value."""
    from keras_nerf_tpu_torch.device import resolve_device

    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    num_rays = args.img_wh * args.img_wh
    chunks = [c for c in args.chunks if c <= num_rays and num_rays % c == 0]
    if not chunks:
        raise SystemExit(f"no --chunks divides the {num_rays} rays")
    cfg, opt, state, dataset, gen = headline(device, args.img_wh)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}  {args.img_wh}^2, {cfg.n_coarse} + {cfg.n_fine} "
          f"samples, {cfg.n_layers} x {cfg.dense_units}", flush=True)
    out = {"device": name, "img_wh": args.img_wh, "iters": args.iters,
           "train_step_ms": {}}
    batch = next(iter(dataset))
    for rc in chunks:
        ms, state = step_ms(state, batch, gen, opt, cfg, rc, args.iters,
                            device)
        out["train_step_ms"][str(rc)] = ms
        print(f"train_step chunks={rc:6d}: {ms:9.3f} ms "
              f"({num_rays / ms * 1e3:,.0f} rays/s)", flush=True)
    rc = chunks[0]
    comps, wall, state = instrumented_step(state, dataset, gen, opt, cfg, rc,
                                           device, iters=args.iters)
    out["components_chunks"] = rc
    out["instrumented_step_ms"] = wall
    out["components_ms"] = comps
    for comp, ms in comps.items():
        print(f"component {comp:>16} (chunks={rc}): {ms:9.3f} ms/step "
              f"({ms / wall:6.1%})", flush=True)
    timeline = host_timeline(state, dataset, gen, opt, cfg, rc, device)
    out["host_timeline"] = timeline
    print(f"host timeline (chunks={rc}): {timeline['launches']} launches, "
          f"first to last {timeline['first_to_last_launch_ms']:.3f} ms, "
          f"host blocked on a full launch queue "
          f"{timeline['queue_full_ms']:.3f} ms; launches by range "
          f"{json.dumps(timeline['launches_by_range'])}", flush=True)
    for g in timeline["longest_gaps"]:
        host = ", ".join(f"{h['name']} {h['ms']:.3f}" for h in g["host"])
        print(f"host gap {g['gap_ms']:8.3f} ms after {g['after']} before "
              f"{g['before']}: {host}", flush=True)
    print(json.dumps({"profile_step": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
