"""What every cell shares: the manifest and the files it names, the check
for JAX, the percentile, the output check's verdict and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "keras_nerf_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str, reported: set[str] | None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    names or, without that key, every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it ``moves`` (a per-layer one,
    as a later metric may be given)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = manifest() if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"nerfbench: no workload named {name!r}")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=entry["chips"],
                config=load_json(ROOT / config["file"]),
                traffic=load_json(HERE / "traffic"
                                  / f"{entry['traffic']}.json"),
                checks=load_json(HERE / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def build_nerf(cfg: dict):
    """The program's ``NeRF`` with the configuration's model."""
    from keras_nerf_tpu_torch.models.nerf import NeRF

    return NeRF(**{k: cfg[k] for k in (
        "n_coarse", "n_fine", "pos_emb_xyz", "pos_emb_dir", "n_layers",
        "dense_units", "skip_layer")})


def driver(kind: str):
    """The traffic driver ``traffic/<kind>.py``."""
    return importlib.import_module(f"nerfbench.traffic.{kind}")


def layer_reader(metric: str):
    """``read(stretch) -> float | None`` of ``layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"nerfbench.layer_metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def p95(values) -> float:
    """The nearest-rank 95th percentile: the ``ceil(0.95 n)``-th smallest."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that
    ``limits`` names; a number that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return ok, out


@dataclasses.dataclass
class Outcome:
    """What a driver hands back for the result line."""

    attempted: int
    end_to_end: dict
    readings: dict
    memory_peak_bytes: int
    window_start: float = 0.0
    stretch: dict | None = None
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
