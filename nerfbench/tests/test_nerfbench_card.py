"""The benchmark on the card: a short run of a cell, and each control at
its cell's own size failing the limits the program passes.

    python -m pytest -m cuda nerfbench/tests/test_nerfbench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from nerfbench import clock, harness
from nerfbench.traffic import render, train


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_short_run_is_correct(card):
    proc = subprocess.run(
        [sys.executable, "-m", "nerfbench.run", "--workload", "k128_render",
         "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", (2 ** 31 + 801, 2 ** 31 + 802))
def test_training_control_fails_at_the_cells_size(card, seed):
    cell = harness.find_cell("k128_train_mse")
    s = train.setup(cell.config, cell.traffic, seed, card)
    prog = train.check_steps(s, cell.checks["check_steps"])
    s.model = s.dataset = None
    clock.free(card)
    ref32 = train.reference_steps(s, prog)
    limits = cell.checks["limits"]
    sound = dict(train.data_checks(s, prog),
                 **train.gaps(train.program_side(prog), ref32))
    control = dict(train.data_checks(s, prog),
                   **train.gaps(train.reference_steps(s, prog, "fp8"), ref32))
    assert harness.verdict(sound, limits)[0], sound
    assert not harness.verdict(control, limits)[0], control


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("k128_render", "blender800_render"))
def test_render_control_fails_at_the_cells_size(card, name):
    cell = harness.find_cell(name)
    seed = 2 ** 31 + 803
    for quantized in (False, True):
        model, weights, poses = render.setup(cell.config, cell.traffic, seed,
                                             card, quantized=quantized)
        picked = render.sample(seed, len(poses), cell.checks["sample_frames"])
        frames = [(p, render.render_frame(model, poses[p])) for p in picked]
        del model
        clock.free(card)
        refs = render.reference_frames(cell.config, weights, poses, picked)
        readings = render.gaps(frames, refs, lambda i: i)
        ok, _ = harness.verdict(readings, cell.checks["limits"])
        assert ok != quantized, readings
