"""The manifest and every file it names, the FLOP count, the check for JAX
and the result line's keys (CPU only)."""

from __future__ import annotations

import json
import re
import sys
import types

import pytest

from nerfbench import flops, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_names(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["nerfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(_line(w) for w in bench["command"])
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in bench[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs_and_cells(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith("nerfbench/configs/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
        assert _line(c["source"]) and _line(c["why"])
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and _line(w["why"])
        cell = harness.find_cell(w["name"], bench)
        assert harness.driver(cell.traffic["kind"]).run
        assert cell.checks["limits"]
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert harness.layer_reader(m["name"])(None) is None


def test_flops_at_8x256(bench):
    cfg = harness.find_cell("k128_train_mse", bench).config
    assert flops.fwd_flop_per_point(cfg) == 1_186_816
    assert flops.fwd_flop_per_point(cfg, sigma_only=True) == 982_528
    assert flops.bwd_dx_flop_per_point(cfg) == 1_115_392
    assert flops.train_flop_per_point(cfg) == 3_489_024
    assert flops.train_flop_per_ray(cfg) == 256 * 3_489_024
    assert flops.render_flop_per_ray(cfg) == 64 * 982_528 + 192 * 1_186_816


def test_import_guard_compares_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    import keras_nerf_tpu_torch  # noqa: F401  (its name begins with the JAX
    # package's, and is allowed)

    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "keras_nerf_tpu_torch.extra",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax.numpy"]
    monkeypatch.setitem(sys.modules, "keras_nerf_tpu", types.ModuleType("x"))
    assert "keras_nerf_tpu" in harness.forbidden_modules()


def test_p95_is_nearest_rank():
    assert harness.p95(range(1, 101)) == 95
    assert harness.p95([3.0]) == 3.0
    assert harness.p95(range(1, 21)) == 19


def test_verdict():
    ok, checks = harness.verdict({"a": 1.0, "b": 0.0},
                                 {"a": 2.0, "b": 0.0})
    assert ok and checks == {"a": {"value": 1.0, "limit": 2.0},
                             "b": {"value": 0.0, "limit": 0.0}}
    assert not harness.verdict({"a": float("nan")}, {"a": 1.0})[0]
    assert not harness.verdict({}, {"a": 1.0})[0]
    assert not harness.verdict({"a": 3.0}, {"a": 2.0})[0]


def test_shares_of_the_wall_use_the_plain_stretch():
    """MFU and the idle share are taken over a step's wall time in the
    plain stretch, which the profiler does not slow; the MLP roofline over
    the traced kernels' own time."""
    from nerfbench.layer_metrics import _stretch

    # 0.1 s of work at the peak a step; 1 s a step untraced, 2 s traced;
    # the device busy 0.5 s a step, 0.375 s of it in the MLP kernels.
    stretch = {"kind": "train", "units": 4, "rays_per_unit": 100,
               "flop_per_ray": 989e12 * 1e-3, "window_s": 8.0,
               "busy_s": 2.0, "plain_units": 4, "plain_s": 4.0,
               "device_ops": [("mlp_forward_kernel<256>", 1.5),
                              ("elementwise_kernel", 0.5)]}
    assert _stretch.mfu_pct(stretch, "train") == pytest.approx(10.0)
    assert _stretch.idle_pct(stretch, "train") == pytest.approx(50.0)
    assert _stretch.mlp_roofline_pct(stretch, "train") == pytest.approx(
        100.0 * 0.4 / 1.5)
    assert _stretch.launches_per_unit(stretch, "train") == 0.5
    assert _stretch.mfu_pct(stretch, "render") is None
    assert _stretch.idle_pct(dict(stretch, plain_units=0), "train") is None
