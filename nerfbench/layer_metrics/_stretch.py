"""What the readers share."""

from __future__ import annotations

from nerfbench import flops


def traced(stretch: dict | None, kind: str) -> bool:
    """A traced stretch of this kind with work and time in it."""
    return (stretch is not None and stretch.get("kind") == kind
            and stretch.get("units", 0) > 0 and stretch.get("window_s", 0) > 0
            and bool(stretch.get("device_ops")))


def model_flops(stretch: dict) -> float:
    return (stretch["flop_per_ray"] * stretch["rays_per_unit"]
            * stretch["units"])


def plain_s_per_unit(stretch: dict) -> float | None:
    """The wall time of a step or frame in the plain stretch, which runs
    just before the traced one and is not slowed by the profiler."""
    if stretch.get("plain_units", 0) <= 0 or stretch.get("plain_s", 0) <= 0:
        return None
    return stretch["plain_s"] / stretch["plain_units"]


def mfu_pct(stretch: dict, kind: str) -> float | None:
    """A step's or frame's model FLOPs over its wall time in the plain
    stretch, at the bf16 peak."""
    if not traced(stretch, kind) or plain_s_per_unit(stretch) is None:
        return None
    flop = model_flops(stretch) / stretch["units"]
    return 100.0 * flop / (plain_s_per_unit(stretch)
                           * flops.PEAK_BF16_FLOPS)


# The bf16 MLP kernels of kernels/csrc: the forward (every mode, resident
# and streamed), the backward's dX chain and the weight gradient's sums.
MLP_KERNELS = ("mlp_forward_kernel", "mlp_streamed_kernel",
               "mlp_backward_kernel", "mlp_backward_streamed_kernel",
               "wg_gemm_kernel", "wg_reduce_kernel")


def mlp_roofline_pct(stretch: dict, kind: str) -> float | None:
    """The MLP work's least time at the bf16 peak over the device time of
    the MLP kernels."""
    if not traced(stretch, kind):
        return None
    busy = sum(sec for name, sec in stretch["device_ops"]
               if any(k in name for k in MLP_KERNELS))
    if busy <= 0:
        return None
    return 100.0 * model_flops(stretch) / flops.PEAK_BF16_FLOPS / busy


def idle_pct(stretch: dict, kind: str) -> float | None:
    """100 minus the device's busy time a step or frame (the traced
    stretch's) over the wall time of one in the plain stretch."""
    if not traced(stretch, kind) or plain_s_per_unit(stretch) is None:
        return None
    busy = stretch["busy_s"] / stretch["units"]
    return 100.0 * (1.0 - busy / plain_s_per_unit(stretch))


def launches_per_unit(stretch: dict, kind: str) -> float | None:
    """Kernels, copies and fills on the device a step or frame."""
    if not traced(stretch, kind):
        return None
    return len(stretch["device_ops"]) / stretch["units"]
