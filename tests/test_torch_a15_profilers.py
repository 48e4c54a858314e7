"""The port's profilers (``profile_render``, ``profile_occtrain``,
``profile_ablate``, ``profile_probe``, ``profile_shard_step``,
``profile_pallas``) against the JAX package and its scripts, on the CPU.

What a profiler computes, beside its times, is held against JAX:

* ``padded_fwd_flop_per_point`` equal to JAX's, integer for integer, over
  widths, depths and skips, full and sigma-only;
* ``profile_probe``'s four gathers equal to JAX's ``occupancy_along_rays``
  bit for bit (seeded rays, a random 32^3 grid, the default box and one
  that cuts the rays), and its bit packing to the JAX script's words;
* the occupancy grid that ``profile_occtrain`` and ``profile_probe`` time
  on equal to the JAX scripts' (``grid_coordinates``, the unit sphere,
  one dilation) bit for bit;
* ``profile_ablate``'s build plan: which macro goes into which source and
  which directory, every macro present in the source it is built into,
  and none in the package's own build (``_build.NVCC_FLAGS`` and the
  commands ``_build.build`` runs, captured). The tool itself needs
  ``nvcc``.

Then each profiler runs at a tiny size with ``--device cpu`` (the kernels'
plain versions, the host clock) and must print the card's line first,
every reading and its JSON record last. Times are not held: a CPU time is
no device time.
"""

import tests.test_torch_threads  # noqa: F401  (torch's share of the cores)
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_nerf_tpu.kernels import ray_march as jrm
from keras_nerf_tpu.models.mlp import MLPConfig as JaxMLPConfig
from keras_nerf_tpu.ops import occupancy as jocc
from keras_nerf_tpu_torch import (profile_ablate, profile_occtrain,
                                  profile_pallas, profile_probe,
                                  profile_render, profile_shard_step)
from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRFConfig
from keras_nerf_tpu_torch.models.mlp import MLPConfig
from keras_nerf_tpu_torch.ops import occupancy as tocc

@pytest.mark.parametrize("units,layers,skip", [
    (256, 8, 4), (128, 2, 1), (512, 4, 3), (256, 5, 4), (768, 3, 2),
    (1024, 10, 4), (256, 1, 1)])
def test_padded_fwd_flop_per_point_equals_jax(units, layers, skip):
    jcfg = JaxMLPConfig(n_layers=layers, dense_units=units, skip_layer=skip)
    tcfg = MLPConfig(n_layers=layers, dense_units=units, skip_layer=skip)
    assert tuple(tcfg.skip_indices()) == tuple(jcfg.skip_indices())
    for sigma_only in (False, True):
        assert (trm.padded_fwd_flop_per_point(tcfg, sigma_only)
                == jrm.padded_fwd_flop_per_point(jcfg, sigma_only))
    assert trm.padded_fwd_flop_per_point(MLPConfig()) == 1_376_256


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] += 4.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("aabb", [tocc.DEFAULT_AABB,
                                  ((-1.0, -1.5, -1.0), (1.0, 1.5, 2.0))])
def test_probe_formulations_equal_jax_bit_for_bit(aabb):
    o, d = _rays(96, 5)
    grid = (np.random.default_rng(6).uniform(size=(32, 32, 32)) > 0.6
            ).astype(np.float32)
    _, want = jocc.occupancy_along_rays(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(grid), 2.0, 6.0, 16,
                                        aabb)
    want = np.asarray(want)
    assert 0 < want.mean() < 1
    probes = profile_probe.formulations(torch.as_tensor(grid), 2.0, 6.0, 16,
                                        aabb)
    assert list(probes) == ["3d f32", "flat f32", "flat uint8",
                            "packbits int32"]
    for name, probe in probes.items():
        got = probe(torch.as_tensor(o), torch.as_tensor(d)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_pack_bits_equals_the_jax_scripts_words():
    grid = (np.random.default_rng(7).uniform(size=(32, 32, 32)) > 0.5
            ).astype(np.float32)
    g = grid.shape[0]
    # scripts/profile_probe.py's packing, in int64 and wrapped to int32.
    bits = (grid.astype(np.int64).reshape(g, g, g // 32, 32)
            << np.arange(32)).sum(-1).reshape(-1)
    want = bits.astype(np.uint32).view(np.int32)
    got = profile_probe.pack_bits(torch.as_tensor(grid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want < 0).any()


def test_timed_grid_equals_the_jax_scripts():
    coords = jocc.grid_coordinates(32)
    want = jocc.dilate_occupancy(
        (jnp.linalg.norm(coords, axis=-1) < 1.0).astype(jnp.float32), 1)
    got = profile_occtrain.sphere_grid(32, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ablation_plan_and_the_packages_build_carries_no_macro(
        monkeypatch, tmp_path):
    plan = profile_ablate.build_plan()
    assert [(e["kernel"], e["ablation"]) for e in plan] == [
        (k, a) for k in ("ray_march_mlp", "ray_march_mlp_int8")
        for a in ("none", "nosin", "noenc", "noepi", "nostash")]
    encode = (_build.CSRC / "encode.cuh").read_text()
    for e in plan:
        assert e["source"] == _build.CSRC / f"{e['kernel']}.cu"
        assert e["out_dir"] == (_build.BUILD_ROOT.parent / "ablate"
                                / e["kernel"] / e["ablation"])
        macro = profile_ablate.ABLATIONS[e["ablation"]]
        assert e["defines"] == ([] if macro is None else [macro])
        text = e["source"].read_text() + encode
        if macro is not None and (e["kernel"], macro) != (
                "ray_march_mlp_int8", "KNT_ABL_NOSTASH"):
            assert f"defined({macro})" in text, (e["kernel"], macro)
    # The int8 forward has no stash: its nostash build is its none build.
    assert "KNT_ABL_NOSTASH" not in (
        (_build.CSRC / "ray_march_mlp_int8.cu").read_text() + encode)
    assert not any("KNT_ABL" in f for f in _build.NVCC_FLAGS)

    cmds = []

    def run(cmd):
        cmds.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return ""

    monkeypatch.setattr(_build, "_run", run)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    _build.build()
    assert len(cmds) == len(_build.sources()) + 1
    assert not any("KNT_ABL" in arg for cmd in cmds for arg in cmd)
    cmds.clear()
    monkeypatch.setattr(_build, "_declare", lambda lib, names: None)
    _build.build_single(plan[1]["source"], tmp_path / "abl", (),
                        plan[1]["defines"])
    assert "-DKNT_ABL_NOSIN" in cmds[0]


def _run_tool(tool, argv, capsys, key):
    record = tool.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    assert json.loads(lines[-1]) == {key: json.loads(json.dumps(record))}
    return record, lines


def test_profile_render_on_the_cpu_prints_every_field(capsys):
    rec, lines = _run_tool(profile_render, ["--img_wh", "8", "--chunks",
                                            "32", "64", "--iters", "1"],
                           capsys, "profile_render")
    assert list(rec["frames"]) == ["32", "64"]
    for split in rec["frames"].values():
        assert split["wall_ms"] > 0 and split["fps"] > 0
        assert split["device_ms"] is split["host_gap_ms"] is None
    assert sum("host gap not measured" in x for x in lines) == 2
    rec, lines = _run_tool(profile_render, ["--img_wh", "8", "--components",
                                            "--chunk", "16", "--iters", "1"],
                           capsys, "profile_render")
    assert list(rec["components"]) == list(profile_render.COMPONENTS)
    assert all(v["ms_per_frame"] == 4 * v["ms_per_chunk"]
               for v in rec["components"].values())


def test_profile_occtrain_on_the_cpu_prints_every_field(capsys):
    rec, _ = _run_tool(profile_occtrain, [
        "--img_wh", "8", "--chunks", "32", "--iters", "1", "--occ_n", "8",
        "--n_probe", "8", "--grid", "16"], capsys, "profile_occtrain")
    assert len(rec["steps"]) == 7 and len(rec["per_chunk_ms"]) == 4
    assert all(s["wall_ms"] > 0 and s["rays_per_s"] > 0
               for s in rec["steps"].values())
    assert 0 < rec["grid_share"] < 1


def test_profile_ablate_on_the_cpu_prints_every_field(capsys):
    rec, lines = _run_tool(profile_ablate, ["--rays", "4", "--samples", "8",
                                            "--iters", "1"], capsys,
                           "profile_ablate")
    assert len(rec["plan"]) == 10 and rec["bit_for_bit"] == {}
    assert sum(line.startswith(("notri", "norep", "noquad"))
               for line in lines) == 3
    assert len(rec["readings"]) == 7
    cfg = NeRFConfig()
    for key, row in rec["readings"].items():
        assert list(row) == list(profile_ablate.ABLATIONS)
        none = row.pop("none")
        assert none["ms"] > 0
        unpadded, padded = profile_ablate.flops_per_point(
            cfg, key.split("] ")[1].split(" ", 1)[1])
        assert none["tflops_padded"] / none["tflops_unpadded"] == \
            pytest.approx(padded / unpadded)
        assert all(r["ms"] is None for r in row.values())


def test_profile_probe_on_the_cpu_prints_every_field(capsys):
    rec, lines = _run_tool(profile_probe, ["--rays", "16", "--n_probe", "8",
                                           "--grid", "32", "--iters", "1"],
                           capsys, "profile_probe")
    assert list(rec["ms"]) == ["3d f32", "flat f32", "flat uint8",
                               "packbits int32"]
    assert sum("equal to 3d f32" in x for x in lines) == 4


def test_profile_probe_raises_when_a_formulation_differs(monkeypatch):
    real = profile_probe.formulations

    def broken(*args):
        out = real(*args)
        flat = out["flat uint8"]
        out["flat uint8"] = lambda o, d: 1.0 - flat(o, d)
        return out

    monkeypatch.setattr(profile_probe, "formulations", broken)
    with pytest.raises(RuntimeError, match="flat uint8 differs"):
        profile_probe.main(["--rays", "8", "--n_probe", "4", "--grid", "32",
                            "--iters", "1", "--device", "cpu"])


def test_profile_shard_step_on_the_cpu_prints_every_field(capsys):
    rec, lines = _run_tool(profile_shard_step, [
        "--img_wh", "8", "--n", "1", "2", "--iters", "1",
        "--steps_per_epoch", "3", "--n_val", "2"], capsys,
        "profile_shard_step")
    assert list(rec["bands"]) == ["1", "2"]
    for n, band in rec["bands"].items():
        assert band["rays"] == 64 // int(n) == band["chunks"]
        # The JAX script's estimate: steps x step + n_val x eval.
        assert band["epoch_s"] == pytest.approx(
            (3 * band["train_step"]["wall_ms"]
             + 2 * band["eval_step"]["wall_ms"]) / 1e3)
    assert "all-reduce" in rec["not_measured"]
    assert all("all-reduce not measured" in x for x in lines[1:-1])


def test_profile_pallas_on_the_cpu_prints_every_field(capsys):
    rec, _ = _run_tool(profile_pallas, [
        "--rays", "4", "--samples", "8", "--img_wh", "8", "--chunks", "32",
        "--iters", "1"], capsys, "profile_pallas")
    assert len(rec["chunk"]) == 2 and list(rec["train_step"]) == ["32"]
    rec, _ = _run_tool(profile_pallas, [
        "--rays", "4", "--samples", "8", "--components", "--launch_points",
        "16", "32", "--iters", "1"], capsys, "profile_pallas")
    assert list(rec["components"]) == [
        "encode_block128 (32 points)",
        "apply_mlp (32 points, 16 a launch)",
        "fused_mlp_backward (32 points, 16 a launch)",
        "apply_mlp (32 points, 32 a launch)",
        "fused_mlp_backward (32 points, 32 a launch)"]


def test_profilers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for tool in (profile_render, profile_occtrain, profile_ablate,
                 profile_probe, profile_shard_step, profile_pallas):
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main([])
