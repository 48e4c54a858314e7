"""The 16^2 card-vs-CPU training-step checks of ``chip_smoke.py`` over a
run of trained states, with this package's forward kernel and, optionally,
another checkout's.

    python -m keras_nerf_tpu_torch.step_draws [--parent DIR] [--epochs 8]

Run from the repository root (it reuses ``chip_smoke.py``'s scene, model
and checks). Trains the smoke test's 8 x 256 model on its 128^2 spheres
views, one epoch (5 steps) at a time, the first half of the epochs with
the MSE and the rest with L1; after each epoch it holds the 16^2 card step
against the CPU step for the MSE, for L1 as ``chip_smoke.py`` holds it
(at the CPU's subgradient, ``_compare_l1_steps``) and for plain L1, each
read against ``STEP_TOL``. With ``--parent`` (the ``kernels/csrc``
directory of another checkout) each state is read twice, the second time
with that checkout's ``ray_march_mlp.cu`` behind the ``ray_march_mlp`` and
``apply_mlp`` wrappers: whether a reading follows the forward kernel or
the trained state. A reading over its budget is printed, not fatal. Needs a
card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from keras_nerf_tpu_torch.kernels import _build
from keras_nerf_tpu_torch.kernels import ray_march as trm
from keras_nerf_tpu_torch.models import NeRF, NeRFConfig


def _use(lib) -> None:
    """Launch the two forward wrappers on ``lib``'s build."""
    trm.ray_march_mlp._launch = (
        lambda *a, **k: trm._ray_march_mlp_cuda(*a, lib=lib, **k))
    trm.apply_mlp._launch = (
        lambda *a, **k: trm._apply_mlp_cuda(*a, lib=lib, **k))


def _restore(launches) -> None:
    trm.ray_march_mlp._launch, trm.apply_mlp._launch = launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="kernels/csrc directory of another checkout")
    ap.add_argument("--epochs", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("step_draws needs an NVIDIA card")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs

    over = []
    cs.fail = over.append
    own = (trm.ray_march_mlp._launch, trm.apply_mlp._launch)
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"new": lambda: _restore(own)}
    if args.parent is not None:
        lib = _build.build_single(
            args.parent / "ray_march_mlp.cu",
            _build.BUILD_ROOT.parent / "parent_ray_march_mlp",
            ("knt_ray_march_mlp", "knt_apply_mlp"))
        builds["parent"] = lambda: _use(lib)
    try:
        _read_states(cs, builds, args.epochs)
    finally:
        _restore(own)
    print(f"{len(over)} readings over their budget")
    for msg in over:
        print("  " + msg)
    return 0


def _read_states(cs, builds: dict, epochs: int) -> None:
    """Train epoch by epoch (on this package's kernels) and read the checks
    at each state with each build: ``builds`` maps a label to the function
    that puts that build behind the wrappers."""
    cfg = NeRFConfig(n_coarse=cs.N_COARSE, n_fine=cs.N_FINE,
                     white_background=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dataset = cs._train_dataset()
    nerf = cs._compile_train(NeRF(config=cfg), "mse")
    small = cs._small_step_inputs(gen)
    for epoch in range(epochs):
        loss = "mse" if epoch < epochs // 2 else "l1"
        builds["new"]()
        cs._compile_train(nerf, "mse" if loss == "mse" else cs.l1_loss)
        nerf.fit(dataset, epochs=1, verbose=False)
        for label, install in builds.items():
            install()
            tag = f"state {epoch} (after an epoch of {loss}), {label} kernel"
            cs._compare_steps(f"{tag}: mse", nerf.state, small, cfg,
                              ("cuda", None), ("cpu", None))
            cs._compare_l1_steps(f"{tag}: l1 at the CPU's subgradient",
                                 nerf.state, small, cfg)
            cs._compare_steps(f"{tag}: plain l1", nerf.state, small, cfg,
                              ("cuda", cs.l1_loss), ("cpu", cs.l1_loss))


if __name__ == "__main__":
    sys.exit(main())
