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
read against ``STEP_TOL``; the MSE step as ``chip_smoke.py`` holds it (the
CPU on the card's fine depths and near-edge clip decisions,
``_compare_mse_steps``, ROADMAP C11), its unpinned reading beside it. For
the MSE step it also prints every leaf's relative norm and relative max
(each device on its own draws) beside the leaf's conditioning
(:func:`conditioning`: a leaf that sums many terms of both signs to a
small total amplifies the bf16 roundings of its terms by that factor), and
the pixel-channels whose clip to [0, 1] decides differently on the card
and on the CPU (:func:`clip_flips`). With ``--parent`` (the ``kernels/csrc``
directory of another checkout) each state is read twice, the second time
with that checkout's ``ray_march_mlp.cu`` behind the ``ray_march_mlp`` and
``apply_mlp`` wrappers: whether a reading follows the forward kernel or
the trained state. A reading over its budget is printed, not fatal. Needs a
card.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def leaf_names(params: dict) -> list:
    """The names of ``params``' leaves, in ``tree_leaves`` order."""
    names = [f"trunk[{i}].{k}" for i, layer in enumerate(params["trunk"])
             for k in layer]
    return names + [f"{key}.{k}" for key in ("sigma", "features",
                                            "rgb_features", "rgb")
                    for k in params[key]]


def conditioning(cs, state, small, cfg) -> list:
    """Per model, per leaf, the conditioning of its gradient as a sum over
    the step's points: ``||sum_p |c_p| || / ||sum_p c_p||`` (Frobenius
    norms), ``c_p`` the point's term (``x_p^T delta_p`` of a kernel,
    ``delta_p`` of a bias), from the float32 reference MSE step on the CPU
    (autograd through ``models/mlp.py``'s dense layers, whose inputs and
    output cotangents a wrapper records)."""
    from keras_nerf_tpu_torch.models import engine
    from keras_nerf_tpu_torch.models import mlp

    cpu = torch.device("cpu")
    batch, draws = small
    p0 = [cs._to(x, cpu) for x in (state.coarse_params, state.fine_params)]
    where = {}   # data_ptr of a leaf -> (model, leaf index)
    for m, params in enumerate(p0):
        for i, leaf in enumerate(engine.tree_leaves(params)):
            where[leaf.data_ptr()] = (m, i)
    sums = {}    # (model, leaf) -> [sum of |terms|, sum of terms]
    dense = mlp._dense

    def recorded(x, p):
        y = dense(x, p)
        if y.requires_grad:
            xs = x.detach().reshape(-1, x.shape[-1]).double()

            def hook(g, xs=xs, p=p):
                gs = g.reshape(-1, g.shape[-1]).double()
                for key, a, t in (
                        (p["kernel"], xs.abs().T @ gs.abs(), xs.T @ gs),
                        (p["bias"], gs.abs().sum(0), gs.sum(0))):
                    k = where[key.data_ptr()]
                    old = sums.get(k, (0.0, 0.0))
                    sums[k] = (old[0] + a, old[1] + t)
            y.register_hook(hook)
        return y

    mlp._dense = recorded
    try:
        engine.train_step(
            engine.TrainState(p0[0], p0[1], {}, {}, 0),
            (batch[0].to(cpu), tuple(x.to(cpu) for x in batch[1])),
            [x.to(cpu) for x in draws], engine.make_optimizer("sgd", 1.0),
            dataclasses.replace(cfg, use_kernels=False), cs.E2E_CHUNK)
    finally:
        mlp._dense = dense
    return [[float(sums[(m, i)][0].norm() / sums[(m, i)][1].norm())
             for i in range(len(engine.tree_leaves(params)))]
            for m, params in enumerate(p0)]


def clip_flips(cs, state, small, cfg, devices=("cpu", "cuda")) -> list:
    """Where the MSE step's clip to [0, 1] decides differently on the card
    and on the CPU: per pass (coarse, fine), the pixel-channels whose
    composite (white background) lies inside (0, 1) on one device and not
    on the other, out of all, and the share of the pass's summed absolute
    residual |image - target| that such pixels carry (the MSE gradient of a
    pixel passes the clip only inside). The MLP runs as the step runs it
    (the kernel on the card, its plain version on the CPU); the composite is
    the plain quadrature's on each device; the fine pass takes the CPU's
    depths on both, so that only the MLP's rounding differs."""
    from keras_nerf_tpu_torch.models import engine

    (images, rays), draws = small
    n_rays = images.shape[1] * images.shape[2]
    chunk = cs.E2E_CHUNK
    o, d, t = (x.reshape(n_rays, -1) for x in rays)
    target = images[..., :3].reshape(n_rays, 3).float().cpu()
    enc = (cfg.pos_emb_xyz, cfg.pos_emb_dir)
    pre, tf = [], None
    for dev in map(torch.device, devices):
        packs = [trm.pack_mlp_params(cs._to(x, dev), cfg.mlp, *enc)
                 for x in (state.coarse_params, state.fine_params)]
        out = {"coarse": [], "fine": []}
        fine_t = []
        for k in range(n_rays // chunk):
            sl = slice(k * chunk, (k + 1) * chunk)
            oo, dd, tc = (x[sl].to(dev) for x in (o, d, t))
            base, slope, masks = trm.ray_encoding_coeffs(oo, dd, *enc)
            for name, packed, tt in (("coarse", packs[0], tc),
                                     ("fine", packs[1], None)):
                if tt is None:
                    tt = (fine_t if tf is None else tf)[k].to(dev)
                rgbs = trm.ray_march_mlp(packed, base, slope, tt, masks)
                img, _, w = trm.ray_march_quadrature.plain(
                    rgbs.reshape(chunk, -1, 4), tt, False, False, True)
                out[name].append((img + (1.0 - w.sum(1))[:, None]).cpu())
                if tf is None and name == "coarse":
                    fine_t.append(trm.sample_merge.plain(
                        tt, w, draws[k].to(dev), tt).cpu())
        tf = fine_t if tf is None else tf
        pre.append({n: torch.cat(v) for n, v in out.items()})
    rows = []
    for name in ("coarse", "fine"):
        b, a = pre[0][name], pre[1][name]
        inside = [(x > 0.0) & (x < 1.0) for x in (a, b)]
        flip = inside[0] != inside[1]
        resid = (b.clamp(0.0, 1.0) - target).abs()
        rows.append((name, int(flip.sum()), flip.numel(),
                     float(resid[flip].sum() / resid[inside[1]].sum()),
                     float((a - b).abs().max())))
    return rows


def _per_leaf(cs, tag, state, small, cfg, kappa) -> None:
    """The MSE step, card against CPU, leaf by leaf beside each leaf's
    conditioning; leaves over ``STEP_TOL`` are marked."""
    (_, g_card), (_, g_cpu) = (cs._one_step(state, small, cfg, dev, None)
                               for dev in ("cuda", "cpu"))
    names = leaf_names(state.coarse_params)
    tol = cs.STEP_TOL
    for model, la, lb, kap in zip(("coarse", "fine"), g_card, g_cpu, kappa):
        for name, a, b, k in zip(names, la, lb, kap):
            rn = float((a - b).norm() / b.norm())
            rm = float((a - b).abs().max() / b.abs().max())
            over = rn > tol["grad_rel_norm"] or rm > tol["grad_rel_max"]
            print(f"{tag}: mse leaf {model} {name}: relative norm {rn:.3e}, "
                  f"relative max {rm:.3e}, conditioning sum|terms|/|sum| "
                  f"{k:.3e}{'  OVER' if over else ''}", flush=True)


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
        kappa = conditioning(cs, nerf.state, small, cfg)
        builds["new"]()
        for name, k, total, share, diff in clip_flips(cs, nerf.state, small,
                                                     cfg):
            print(f"state {epoch}: mse clip decisions, {name} pass: {k} of "
                  f"{total} pixel-channels differ between the card and the "
                  f"CPU, carrying {share:.3e} of the CPU's summed residual "
                  f"inside the clip; composites differ by at most "
                  f"{diff:.3e}", flush=True)
        for label, install in builds.items():
            install()
            tag = f"state {epoch} (after an epoch of {loss}), {label} kernel"
            _per_leaf(cs, tag, nerf.state, small, cfg, kappa)
            cs._compare_mse_steps(f"{tag}: mse", nerf.state, small, cfg)
            cs._compare_l1_steps(f"{tag}: l1 at the CPU's subgradient",
                                 nerf.state, small, cfg)
            cs._compare_steps(f"{tag}: plain l1", nerf.state, small, cfg,
                              ("cuda", cs.l1_loss), ("cpu", cs.l1_loss))


if __name__ == "__main__":
    sys.exit(main())
