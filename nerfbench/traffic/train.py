"""Training traffic: ``NeRF.fit`` over the port's ``NeRFDataset``
(whole images, shuffled), epochs until the deadline, in a closed loop.
The mix names the loss (``"loss"``) and may add keyword arguments of
``NeRF.compile`` (``"compile"``, such as an opt-in tier's flags).

Set-up makes the scene's views, both models' weights and the draws from
the seed, builds one ``NeRF`` and one dataset, and drives the first
``check_steps`` steps through ``NeRF.train_step`` (the step ``fit`` runs)
on the dataset's own batches, with fine draws made here; the same model
then trains in the window. After the window the plain reference follows
those first steps from the same weights, views and draws and the
dataset's depths, and the check compares the first step's losses, the
first gradient (Adam's first moment after one step over ``1 - b1``) and
each parameter's change after the steps, which is where the optimizer's
update shows (:func:`gaps`).
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from nerfbench import clock, flops, harness, inputs, scene
from nerfbench.reference import nerf as ref
from nerfbench.trace import Stretch, describe, traced_stretch


def l1_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """The mean absolute error: ``compile(loss=...)``'s callable form."""
    return torch.mean(torch.abs(y_pred - y_true))


# The traffic's "loss" -> what NeRF.compile takes ("mse" is the fused path).
PROGRAM_LOSSES = {"mse": "mse", "l1": l1_loss}


class WindowClosed(Exception):
    pass


@dataclasses.dataclass
class Setup:
    cfg: dict
    traffic: dict
    device: torch.device
    model: object
    dataset: object
    images: np.ndarray
    poses: np.ndarray
    focal: float
    initial: tuple          # the weights handed to the program, cloned
    draws: torch.Generator


@dataclasses.dataclass
class Steps:
    """What the program did in the checked steps."""

    losses: list            # [(coarse, fine)] per step
    first_grads: list       # leaves, coarse then fine
    changes: list           # leaves: parameters after the steps - before
    indices: list           # the batch's image indices, per step
    images: list            # the uploaded images [B, H, W, 4], per step
    rays: list              # (origin, direction, points), per step
    draws: list             # [chunks, ray_chunks, n_fine], per step


def _clone(tree) -> list[torch.Tensor]:
    return [x.detach().clone() for _, x in ref.leaves(tree)]


def setup(cfg: dict, traffic: dict, seed: int,
          device: torch.device) -> Setup:
    from keras_nerf_tpu_torch.data import NeRFDataset
    from keras_nerf_tpu_torch.models.engine import TrainState

    s_scene, s_weights, s_data, s_draws, s_model = inputs.derive_seeds(seed, 5)
    images, poses, focal = scene.training_views(s_scene, cfg["n_views"],
                                                cfg["img_wh"])
    gen = torch.Generator(device=device).manual_seed(s_weights)
    coarse = inputs.make_params(gen, cfg)
    fine = inputs.make_params(gen, cfg)
    initial = (_clone(coarse), _clone(fine))
    wh = cfg["img_wh"]
    model = harness.build_nerf(cfg)
    model.compile(optimizer=cfg["optimizer"],
                  loss=PROGRAM_LOSSES[traffic["loss"]],
                  batch_size=cfg["batch_size"], image_height=wh,
                  image_width=wh, ray_chunks=cfg["train_ray_chunks"],
                  white_background=cfg["white_background"],
                  learning_rate=cfg["learning_rate"], seed=s_model % 2 ** 31,
                  device=device, **traffic.get("compile", {}))
    model.state = TrainState(coarse, fine, model.optimizer.init(coarse),
                             model.optimizer.init(fine), 0)
    dataset = NeRFDataset(images, poses, focal=focal, near=cfg["near"],
                          far=cfg["far"], n_samples=cfg["n_coarse"],
                          batch_size=cfg["batch_size"], shuffle=True,
                          seed=s_data % 2 ** 31, device=device)
    return Setup(cfg, traffic, device, model, dataset, images, poses, focal,
                 initial, torch.Generator(device=device).manual_seed(s_draws))


def check_steps(s: Setup, n: int) -> Steps:
    """The program's first ``n`` steps, through ``NeRF.train_step`` on the
    dataset's batches with draws made here; everything kept is cloned, so
    later steps cannot change it."""
    cfg, model = s.cfg, s.model
    rays = cfg["batch_size"] * cfg["img_wh"] ** 2
    chunk = cfg["train_ray_chunks"]
    out = Steps([], [], [], [], [], [], [])
    batches = iter(s.dataset)
    for k in range(n):
        images, (origin, direction, points) = next(batches)
        out.indices.append(np.array(s.dataset.last_indices))
        out.images.append(images.detach().clone())
        out.rays.append(tuple(x.detach().clone()
                              for x in (origin, direction, points)))
        draws = inputs.sorted_draws(s.draws, (rays // chunk, chunk),
                                    cfg["n_fine"])
        out.draws.append(draws)
        metrics = model.train_step((images, (origin, direction, points)),
                                   fine_draws=list(draws.unbind(0)),
                                   indices=out.indices[-1])
        out.losses.append((metrics["coarse_loss"], metrics["fine_loss"]))
        if k == 0:
            st = model.state
            out.first_grads = [m / (1.0 - ref.ADAM_B1) for m in
                               _clone(st.coarse_opt["mu"])
                               + _clone(st.fine_opt["mu"])]
    st = model.state
    after = _clone(st.coarse_params) + _clone(st.fine_params)
    out.changes = [a - b for a, b in zip(after, s.initial[0] + s.initial[1])]
    return out


def _tree(cfg: dict, flat: list[torch.Tensor]) -> dict:
    """Leaves in :func:`ref.leaves` order -> a parameter tree."""
    it = iter(flat)
    tree = {"trunk": [{"kernel": next(it), "bias": next(it)}
                      for _ in range(cfg["n_layers"])]}
    for name in ("sigma", "features", "rgb_features", "rgb"):
        tree[name] = {"kernel": next(it), "bias": next(it)}
    return tree


def reference_steps(s: Setup, prog: Steps, precision: str = "float32",
                    keep_share: float = 1.0, lr_scale: float = 1.0,
                    betas: tuple = (ref.ADAM_B1, ref.ADAM_B2)) -> dict:
    """The reference's own losses, first gradients and changes over the
    program's steps: the same initial weights, views and draws, its own
    rays, the dataset's depths. Planted faults: ``keep_share < 1`` trains
    on that leading share of each batch's rays, ``lr_scale`` scales Adam's
    learning rate, ``betas`` replaces its ``(b1, b2)``."""
    cfg = s.cfg
    lr = cfg["learning_rate"] * lr_scale
    n_c = len(s.initial[0])
    params = [_tree(cfg, [x.clone() for x in s.initial[m]]) for m in (0, 1)]
    states = [None, None]
    losses, first = [], None
    for k in range(len(prog.losses)):
        idx = prog.indices[k]
        target = torch.as_tensor(s.images[idx][..., :3],
                                 device=s.device).reshape(-1, 3)
        o, d = _reference_rays(s, idx)
        t = prog.rays[k][2].reshape(-1, cfg["n_coarse"])
        u = prog.draws[k].reshape(-1, cfg["n_fine"])
        keep = None
        if keep_share < 1.0:
            keep = torch.arange(o.shape[0], device=s.device) < int(
                keep_share * o.shape[0])
        loss, grads, _ = ref.gradients(
            params[0], params[1], target, o, d, t, u, cfg, s.traffic["loss"],
            precision, keep=keep)
        losses.append(loss)
        if k == 0:
            first = [x for g in grads for _, x in ref.leaves(g)]
        for m in (0, 1):
            params[m], states[m] = ref.adam(params[m], grads[m], states[m],
                                            lr, *betas)
    after = [x for p in params for _, x in ref.leaves(p)]
    init = list(s.initial[0]) + list(s.initial[1])
    assert len(first) == len(init) == 2 * n_c
    return {"losses": losses, "first_grads": first,
            "changes": [a - b for a, b in zip(after, init)]}


def _reference_rays(s: Setup, idx) -> tuple[torch.Tensor, torch.Tensor]:
    wh = s.cfg["img_wh"]
    rays = [ref.pose_rays(torch.as_tensor(s.poses[i], device=s.device), wh,
                          wh, s.focal) for i in idx]
    return (torch.stack([r[0] for r in rays]).reshape(-1, 3),
            torch.stack([r[1] for r in rays]).reshape(-1, 3))


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _leaf_gaps(test: list, ref_leaves: list) -> list[float]:
    """``| |t| - |r| |`` of each leaf over the larger of ``|r|`` and the
    median leaf's ``|r|``."""
    r_norms = [_norm(r) for r in ref_leaves]
    med = statistics.median(r_norms)
    return [abs(_norm(t) - rn) / max(rn, med, 1e-30)
            for t, rn in zip(test, r_norms)]


def _leaf_errors(test: list, ref_leaves: list) -> list[float]:
    """``|t - r|`` of each leaf over the larger of ``|r|`` and the median
    leaf's ``|r|``."""
    r_norms = [_norm(r) for r in ref_leaves]
    med = statistics.median(r_norms)
    return [_norm(t - r) / max(rn, med, 1e-30)
            for t, r, rn in zip(test, ref_leaves, r_norms)]


def gaps(test: dict, reference: dict) -> dict:
    """Relative gaps of ``test``'s steps from the reference's:
    ``loss1_gap`` (the first step's worse coarse or fine loss),
    ``grad_gap`` (the worst leaf's first gradient, by the gap of the
    norms), ``grad_err_median`` (the median leaf's norm of the first
    gradient's difference), ``change_gap`` and ``change_gap_median`` (the
    worst and the median leaf's change after the steps, by the gap of the
    norms: Adam's first steps move each weight by about the learning rate
    whatever rounding does to the gradient, so the median leaf's change
    sees a wrong learning rate or betas). A leaf's reading is over the
    larger of its reference norm and the median leaf's; the changes count
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    g_norms = [_norm(g) for g in reference["first_grads"]]
    g_med = statistics.median(g_norms)
    moving = [g >= 1e-3 * g_med for g in g_norms]

    def moved(values):
        return [v for v, m in zip(values, moving) if m]

    return {
        "loss1_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
            test["losses"][0], reference["losses"][0])),
        "grad_gap": max(_leaf_gaps(test["first_grads"],
                                   reference["first_grads"])),
        "grad_err_median": statistics.median(_leaf_errors(
            test["first_grads"], reference["first_grads"])),
        "change_gap": max(moved(_leaf_gaps(test["changes"],
                                           reference["changes"]))),
        "change_gap_median": statistics.median(moved(_leaf_gaps(
            test["changes"], reference["changes"]))),
    }


def data_checks(s: Setup, prog: Steps) -> dict:
    """The data layer's batches: ``images_gap`` against the views the
    benchmark made, ``rays_gap`` against the reference's rays, and
    ``depth_strata``, the number of depths outside [near, far] or outside
    their stratum."""
    cfg = s.cfg
    n, near, far = cfg["n_coarse"], cfg["near"], cfg["far"]
    step = (far - near) / n
    centres = torch.linspace(near, far, n, device=s.device,
                             dtype=torch.float64)
    images_gap = rays_gap = 0.0
    strata = 0
    for k, idx in enumerate(prog.indices):
        mine = torch.as_tensor(s.images[idx], device=s.device)
        images_gap = max(images_gap,
                         float((prog.images[k] - mine).abs().max()))
        o, d = _reference_rays(s, idx)
        origin, direction, points = prog.rays[k]
        rays_gap = max(rays_gap,
                       float((origin.reshape(-1, 3) - o).abs().max()),
                       float((direction.reshape(-1, 3) - d).abs().max()))
        t = points.reshape(-1, n).double()
        bad = ((t < near) | (t > far)
               | ((t - centres).abs() > step / 2 * (1 + 1e-5) + 1e-6))
        strata += int(bad.sum())
    return {"images_gap": images_gap, "rays_gap": rays_gap,
            "depth_strata": float(strata)}


def program_side(prog: Steps) -> dict:
    return {"losses": prog.losses, "first_grads": prog.first_grads,
            "changes": prog.changes}


class _Feed:
    """The dataset as ``fit`` sees it in the window: each batch is the
    dataset's own until the deadline, which ends the epoch. A mark on the
    device's timeline before each batch is handed over times the steps;
    the host clock times the dataset's iterator; the plain and traced
    stretches start and stop between batches."""

    def __init__(self, dataset, deadline: float, marks: clock.Marks,
                 stretch: Stretch | None):
        self.dataset = dataset
        self.deadline = deadline
        self.marks = marks
        self.stretch = stretch
        self.steps = 0
        self.data_s: list[float] = []

    @property
    def last_indices(self):
        return self.dataset.last_indices

    def __iter__(self):
        batches = iter(self.dataset)
        while time.perf_counter() < self.deadline:
            if self.stretch is not None:
                self.stretch.between(self.steps)
            t = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            self.data_s.append(time.perf_counter() - t)
            self.marks.mark()
            self.steps += 1
            yield batch


class _Deadline:
    """Ends ``fit`` after the epoch in which the window closed."""

    def __init__(self, deadline: float):
        self.deadline = deadline

    def on_epoch_end(self, epoch, logs):
        if time.perf_counter() >= self.deadline:
            raise WindowClosed


def warm_up(s: Setup, n: int = 2) -> None:
    """``fit`` over ``n`` of the dataset's batches: its own metric fetch."""
    s.model.fit([batch for _, batch in zip(range(n), s.dataset)], epochs=1,
                verbose=False)


def window(s: Setup, seconds: float, stretch: Stretch | None) -> dict:
    """``fit`` until ``seconds`` have passed; its steps, their times on
    the device's timeline, the wall and the iterator's host times."""
    marks = clock.Marks(s.device)
    clock.sync(s.device)
    t0 = time.perf_counter()
    feed = _Feed(s.dataset, t0 + seconds, marks, stretch)
    try:
        s.model.fit(feed, epochs=2 ** 62, verbose=False,
                    callbacks=[_Deadline(t0 + seconds)])
    except WindowClosed:
        pass
    marks.mark()
    if stretch is not None:
        stretch.close(feed.steps)
    clock.sync(s.device)
    wall = time.perf_counter() - t0
    return {"t0": t0, "wall_s": wall, "steps": feed.steps,
            "step_ms": marks.intervals_ms(), "data_s": feed.data_s}


def compare(s: Setup, prog: Steps) -> dict:
    readings = data_checks(s, prog)
    readings.update(gaps(program_side(prog), reference_steps(s, prog)))
    return readings


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device) -> harness.Outcome:
    cfg, traffic, checks = cell.config, cell.traffic, cell.checks
    s = setup(cfg, traffic, seed, device)
    prog = check_steps(s, checks["check_steps"])
    warm_up(s)
    stretch = traced_stretch(trace, device, checks["trace"])
    w = window(s, seconds, stretch)
    peak = clock.memory_peak(device)
    rays = cfg["batch_size"] * cfg["img_wh"] ** 2
    e2e = {"train_rays_per_s": w["steps"] * rays / w["wall_s"],
           "train_step_ms_p95": harness.p95(w["step_ms"])}
    s.model = s.dataset = None
    clock.free(device)
    readings = compare(s, prog)
    out = harness.Outcome(attempted=w["steps"], end_to_end=e2e,
                          readings=readings, memory_peak_bytes=peak,
                          window_start=w["t0"])
    layer = {"kind": "train", "units": 0, "rays_per_unit": rays,
             "flop_per_ray": flops.train_flop_per_ray(cfg),
             "data_host_s": w["data_s"]}
    out.stretch = describe(stretch, out, layer)
    return out
