"""What the profiling tools share: the card's line, device ms over rotating
inputs by CUDA events, and a run's wall, device-busy ms, host gap and
launches under ``torch.profiler``.

On the CPU (``--device cpu``, the tests) the host clock stands in for the
events and the device columns read ``None`` ("not measured").
"""

from __future__ import annotations

import subprocess
import time

import torch

# The runtime calls that put work on the card, as profile_step counts them.
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy")


def card_line(device: torch.device) -> str:
    """``name, power limit`` as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them for ``device``; ``cpu`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()


def start(argv_device: str) -> tuple[torch.device, str]:
    """Resolves ``argv_device`` (the card unless ``cpu``; no card raises)
    and prints the card's line, the first line of every tool."""
    from keras_nerf_tpu_torch.device import resolve_device

    device = resolve_device(argv_device)
    card = card_line(device)
    print(card, flush=True)
    return device, card


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fmt(x, spec: str = ".3f") -> str:
    return "not measured" if x is None else format(x, spec)


def device_ms(call, n_inputs: int, iters: int, device: torch.device,
              warmup: int = 2) -> float:
    """Ms per ``call(i)``, ``i`` rotating over ``n_inputs`` input sets.

    On the card: after ``warmup`` calls, a spin kernel holds the stream
    while the host enqueues ``iters`` calls between two CUDA events, so the
    events time the card's work and not the host's launches. On the CPU:
    the host clock over the same calls."""
    for i in range(warmup):
        call(i % n_inputs)
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            call(i % n_inputs)
        return 1e3 * (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    call(0)
    sync(device)
    host_s = time.perf_counter() - t0
    torch.cuda._sleep(int(2e9 * (2 * iters * host_s + 1e-3)))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        call(i % n_inputs)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def wall_ms(call, n_inputs: int, iters: int, device: torch.device,
            warmup: int = 1) -> float:
    """Host-clock ms per ``call(i)`` as the host paces them (``i`` rotating
    over ``n_inputs``), the card synchronized before and after."""
    for i in range(warmup):
        call(i % n_inputs)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        call(i % n_inputs)
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / iters


def profiled(call, device: torch.device) -> dict:
    """``call()`` once under ``torch.profiler``: the device's busy ms (the
    union of the card's kernel, copy and fill spans) and the host's
    launches onto the card. On the CPU both are None, and nothing runs."""
    if device.type != "cuda":
        return {"device_ms": None, "launches": None}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        call()
        sync(device)
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                   if ev.device_type != cpu and not ev.is_user_annotation)
    busy, reach = 0.0, float("-inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    launches = sum(1 for ev in events if ev.device_type == cpu
                   and ev.name.startswith(LAUNCH_PREFIXES))
    return {"device_ms": busy / 1e3, "launches": launches}


def run_split(call, n_inputs: int, iters: int, device: torch.device) -> dict:
    """A whole run (a frame, a step) as the host paces it: ``wall_ms`` by the
    host clock over ``iters`` calls, then one more call profiled:
    ``device_ms`` (busy), ``host_gap_ms`` (wall - device) and
    ``launches``."""
    wall = wall_ms(call, n_inputs, iters, device)
    prof = profiled(lambda: call(0), device)
    gap = None if prof["device_ms"] is None else wall - prof["device_ms"]
    return {"wall_ms": wall, "device_ms": prof["device_ms"],
            "host_gap_ms": gap, "launches": prof["launches"]}


def split_line(label: str, split: dict) -> str:
    return (f"{label}: wall {split['wall_ms']:.3f} ms, device "
            f"{fmt(split['device_ms'])} ms, host gap "
            f"{fmt(split['host_gap_ms'])} ms, launches "
            f"{fmt(split['launches'], '.0f')}")
