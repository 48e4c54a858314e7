"""Whole runs of every cell on the CPU at a tiny size, through the port's
plain path: the result line, the reference against that path, the
control and the planted faults each coming out not correct, and a
checkout without the program refusing to run.

The tiny cells keep the model's kind (coarse + fine, skip, L = 10 / 4) at
4 x 256, 16 + 16 samples, 16 x 16 pixels. Their limits are set from the
tiny size's own readings, plain path against the reference: over seeds
50-55 and 2**31 + 5 the first-step loss gap at most 0.0033, the change
gap at most 0.055 and the median leaf's at most 0.0029 (Adam's learning
rate times 1.2: at least 0.17); over seeds 70-75 and 2**31 + 5 the image's 99th-percentile error
at most 0.008, the int8 tier's at least 0.0207, the share of channel
values off by more than half an 8-bit step at most 22.8%, the int8 tier's
at least 82.7%. Each fault below reads above its limit.
"""

from __future__ import annotations

import copy
import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from nerfbench import harness, run
from nerfbench.traffic import render, train

TINY = dict(n_layers=4, skip_layer=2, n_coarse=16, n_fine=16, img_wh=16,
            n_views=4, train_ray_chunks=64, render_ray_chunks=64)
TINY_TRAIN = {"images_gap": 0.0, "rays_gap": 1e-5, "depth_strata": 0.0,
              "loss1_gap": 0.06, "change_gap": 0.25,
              "change_gap_median": 0.03}
TINY_LIMITS = {
    "k128_train_mse": TINY_TRAIN, "k128_train_l1": TINY_TRAIN,
    "k128_render": {"image_p99": 0.013},
    "blender800_render": {"image_off_pct": 50.0},
}
RENDER_CELLS = ("k128_render", "blender800_render")
CELLS = ("k128_train_mse", "k128_train_l1", "k128_render",
         "blender800_render")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.find_cell(name))
    kind = cell.traffic["kind"]
    cell.config = dict(cell.config, **TINY)
    if kind == "render":
        cell.traffic = dict(cell.traffic, frames=4)
    cell.checks = dict(cell.checks, limits=TINY_LIMITS[name],
                       sample_frames=4, trace={"from": 2, "units": 2})
    return cell


def run_line(monkeypatch, name: str, seed: int = 2 ** 31 + 5,
             seconds: float = 0.5, trace: int = 0) -> dict:
    cell = tiny_cell(name)
    monkeypatch.setattr(harness, "find_cell", lambda _name, bench=None: cell)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], device=CPU)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_agrees_with_reference(monkeypatch, name):
    line = run_line(monkeypatch, name)
    cell = tiny_cell(name)
    assert list(line) == KEYS
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(cell.checks["limits"])
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


@pytest.mark.parametrize("name", ("k128_train_mse", "k128_render"))
def test_traced_run_reports_layer_metrics_only(monkeypatch, name):
    line = run_line(monkeypatch, name, trace=1)
    cell = tiny_cell(name)
    assert [k for k in line if k != "breakdown"] == KEYS
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"busy_s", "window_s"} <= set(line["device"])


def _wrap_train_step(monkeypatch, fault):
    from keras_nerf_tpu_torch.models import engine

    original = engine.train_step

    def faulty(state, batch, *args, **kwargs):
        return fault(original, state, batch, *args, **kwargs)

    monkeypatch.setattr(engine, "train_step", faulty)


def _unchanged(original, state, batch, *args, **kwargs):
    _, metrics = original(state, batch, *args, **kwargs)
    return state, metrics


def _half_batch(original, state, batch, *args, **kwargs):
    images, rays = batch
    h = images.shape[1] // 2
    draws = args[0]
    if not isinstance(draws, torch.Generator):
        draws = list(draws)[:len(list(draws)) // 2]
    return original(state, (images[:, :h], tuple(r[:, :h] for r in rays)),
                    draws, *args[1:], **kwargs)


def _loss_altered(original, state, batch, *args, **kwargs):
    state, metrics = original(state, batch, *args, **kwargs)
    metrics["fine_loss"] = metrics["fine_loss"] * 1.2
    return state, metrics


@pytest.mark.parametrize("fault", (_unchanged, _half_batch, _loss_altered),
                         ids=("state_unchanged", "half_batch",
                              "answer_altered"))
def test_training_fault_is_not_correct(monkeypatch, fault):
    _wrap_train_step(monkeypatch, fault)
    line = run_line(monkeypatch, "k128_train_mse")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ("k128_train_mse", "k128_train_l1"))
def test_training_wrong_learning_rate_is_not_correct(monkeypatch, name):
    """The program's Adam at 1.2 times the configured learning rate: the
    median leaf's change after the checked steps catches it."""
    from keras_nerf_tpu_torch.models.nerf import NeRF

    compile_ = NeRF.compile

    def faulty(self, *args, **kwargs):
        kwargs["learning_rate"] = 1.2 * kwargs["learning_rate"]
        return compile_(self, *args, **kwargs)

    monkeypatch.setattr(NeRF, "compile", faulty)
    line = run_line(monkeypatch, name)
    assert not line["correct"], line["checks"]
    check = line["checks"]["change_gap_median"]
    assert check["value"] > check["limit"], check


def _wrap_render(monkeypatch, fault):
    from keras_nerf_tpu_torch.models import engine

    original = engine.render_image_batch

    def faulty(*args, **kwargs):
        coarse, fine = original(*args, **kwargs)
        return coarse, fault(fine)

    monkeypatch.setattr(engine, "render_image_batch", faulty)


def _rows_left_out(fine):
    h = fine["image"].shape[1] // 2
    fine["image"][:, h:] = 1.0
    fine["depth"][:, h:] = 0.0
    return fine


def _image_altered(fine):
    fine["image"] = fine["image"] + 0.02
    return fine


@pytest.mark.parametrize("name", RENDER_CELLS)
@pytest.mark.parametrize("fault", (_rows_left_out, _image_altered),
                         ids=("half_batch", "answer_altered"))
def test_render_fault_is_not_correct(monkeypatch, fault, name):
    _wrap_render(monkeypatch, fault)
    line = run_line(monkeypatch, name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", RENDER_CELLS)
def test_render_control_int8_is_not_correct(monkeypatch, name):
    """The control of the render cells: the program's own int8 tier."""
    setup = render.setup
    monkeypatch.setattr(render, "setup", lambda *a, **k: setup(
        *a, **dict(k, quantized=True)))
    line = run_line(monkeypatch, name)
    assert not line["correct"], line["checks"]


# The training control needs more rays than the tiny cells hold: at 32 x
# 32 pixels, 8 x 256, 32 + 32 samples, over seeds 300-303, the plain
# path's first-step loss gap read at most 0.00062 and its median leaf's
# gradient error at most 0.0097, the float8 reference's at least 0.0013
# and 0.041.
CONTROL_SIZE = dict(n_coarse=32, n_fine=32, img_wh=32, n_views=4,
                    train_ray_chunks=256)


@pytest.mark.parametrize("seed", (300, 301))
def test_training_control_fp8_is_not_correct(seed):
    """The control of the training cells, the reference in float8 operands
    in the program's place, fails the MSE cell's own limits on the first
    step (its loss and the median leaf's gradient) where the plain path
    passes them."""
    cell = harness.find_cell("k128_train_mse")
    limits = {k: cell.checks["limits"][k]
              for k in ("loss1_gap", "grad_err_median")}
    s = train.setup(dict(cell.config, **CONTROL_SIZE), cell.traffic, seed,
                    CPU)
    prog = train.check_steps(s, 3)
    ref32 = train.reference_steps(s, prog)
    control = train.gaps(train.reference_steps(s, prog, "fp8"), ref32)
    sound = train.gaps(train.program_side(prog), ref32)
    assert harness.verdict(sound, limits)[0], sound
    assert not harness.verdict(control, limits)[0], control


def test_checkout_without_the_program_does_not_run(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "nerfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; from nerfbench import run; "
            "sys.exit(run.main(['--workload', 'k128_render', '--seed', '1', "
            "'--seconds', '1'], device=torch.device('cpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "keras_nerf_tpu_torch" in proc.stderr
    assert not proc.stdout.strip()
