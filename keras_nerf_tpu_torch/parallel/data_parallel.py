"""Synchronous data parallelism over ``torch.distributed`` (port of
``keras_nerf_tpu/parallel/data_parallel.py``).

The JAX package runs one controller over a device mesh (``shard_map`` and
``pmean``); this port runs one process per card, each holding a
:class:`Group`, the counterpart of the mesh:

* parameters and optimizer state are replicated: every rank holds the same
  ``TrainState``, broadcast from rank 0 once (:func:`replicate`);
* every rank runs ``engine.train_step`` on its share of the global batch
  (:func:`shard_batch`) and all-reduces the averaged gradients before the
  optimizer, one flat buffer per model (JAX's ``pmean`` of the gradients,
  `engine.py:796-798`); the step's metrics are averaged last. The
  gradients of the fused path come out of the kernels, not out of autograd,
  so the all-reduce is explicit (``DistributedDataParallel`` does not fit);
* each rank's fine draws come from a generator of its own, seeded from
  ``(seed, rank)`` (:func:`rank_seed`; JAX's ``fold_in(key, axis_index)``);
* whole-image renders are split into height bands, one a rank, and
  all-gathered back into whole images (:func:`sharded_render`,
  :func:`sharded_render_occ`).

Semantics are JAX's: ``global_batch = batch_size * world`` with the batch
split along its leading axis; with ``shard_rays`` every image's height is
split instead, so the global batch stays ``batch_size`` and the averaged
gradient is the whole batch's; ``ray_chunks`` is per rank.

Backends: NCCL for ranks on a card, gloo on the CPU, chosen by the device
type (:func:`make_group`); gloo over CUDA tensors is there for ranks that
share one card, and only when asked for by name. Neither gives way to the
other: a failed init raises. Every function takes its group explicitly and
never touches the default process group, so tests may run ranks as threads
of one process, each with its own ``ProcessGroupGloo`` over one store.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import NamedTuple

import torch
import torch.distributed as dist

from keras_nerf_tpu_torch.models import engine
from keras_nerf_tpu_torch.models.engine import NeRFConfig

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)   # torch's own default


@dataclasses.dataclass(eq=False)
class Group:
    """One rank's handle on a process group: its rank, the world size, the
    device its tensors live on and the backend. The collectives block the
    host until their result is usable on ``device``."""

    pg: object
    rank: int
    size: int
    device: torch.device
    backend: str

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place."""
        self.pg.allreduce([tensor]).wait()
        return tensor

    def all_gather(self, tensor: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``tensor``, concatenated along ``dim`` in rank
        order (``all_gather(..., tiled=True)``)."""
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.size)]
        self.pg.allgather([parts], [tensor]).wait()
        return torch.cat(parts, dim=dim)

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``tensor`` on every rank, in place (through a
        contiguous copy where it is not contiguous)."""
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        buf = tensor.contiguous()
        self.pg.broadcast([buf], opts).wait()
        if buf is not tensor:
            tensor.copy_(buf)
        return tensor

    def barrier(self) -> None:
        """Returns once every rank has reached it (an all-reduce whose
        result the host reads)."""
        flag = torch.zeros(1, device=self.device)
        float(self.all_reduce_(flag))

    def close(self) -> None:
        if hasattr(self.pg, "shutdown"):
            self.pg.shutdown()


def make_group(n: int, backend: str | None = None, rank: int = 0,
               store=None, *, device="cpu", n_slices: int = 1,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Group:
    """Rank ``rank`` of an ``n``-rank group (the counterpart of
    ``make_mesh``, `data_parallel.py:43-72`).

    Args:
      backend: ``"nccl"`` or ``"gloo"``; None picks by ``device``'s type:
        NCCL on a card, gloo on the CPU. ``"gloo"`` with a CUDA device runs
        gloo over CUDA tensors (ranks that share one card).
      store: the ``torch.distributed`` store every rank meets at (a
        ``FileStore`` across processes, one ``HashStore`` across threads);
        None makes a ``HashStore``, which serves a one-rank group.
      device: this rank's device; ``"cuda"`` without an index is
        ``cuda:{rank}``, one card a rank.
      n_slices: accepted and checked as JAX checks it (it must divide
        ``n``), then the group is flat: on one node the 2-D mesh's
        arithmetic is the 1-D mesh's.

    Raises ``ValueError`` for more ranks than cards, an ``n_slices`` that
    does not divide ``n`` or a rank outside ``[0, n)``, and whatever the
    backend raises when it cannot connect: the group runs one collective
    before it is returned, so a failed NCCL init raises here.
    """
    if n_slices < 1 or n % n_slices:
        raise ValueError(f"{n} devices do not divide into {n_slices} slices")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a group of {n}")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank)
        count = torch.cuda.device_count()
        if device.index >= count or (backend in (None, "nccl") and n > count):
            raise ValueError(f"requested a {n}-device group but only {count} "
                             f"device(s) are available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if store is None:
        store = dist.HashStore()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend needs CUDA devices")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL")
        torch.cuda.set_device(device)
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(store, rank, n, opts)
    elif backend == "gloo":
        if device.type == "cuda":
            torch.cuda.set_device(device)
        pg = dist.ProcessGroupGloo(store, rank, n, timeout)
    else:
        raise ValueError(f"unsupported backend {backend!r} (use 'nccl' or "
                         f"'gloo')")
    group = Group(pg, rank, n, device, backend)
    group.barrier()
    return group


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own generator, from ``(seed, rank)``:
    ``seed`` itself at rank 0, so a one-rank group draws what an ungrouped
    run draws."""
    return int(seed) + (int(rank) << 32)


class BatchSharding(NamedTuple):
    """The layout of a global ``(images, rays)`` batch over a group (the
    loader's ``sharding=``): split along its leading (image) axis, or with
    ``shard_rays`` along its height axis (`data_parallel.py:104-123`)."""

    group: Group
    shard_rays: bool = False


def _share(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    size = x.shape[dim]
    if size % group.size:
        what = "image height" if dim == 1 else "batch"
        raise ValueError(f"{what} {size} does not divide over {group.size} "
                         f"ranks")
    n = size // group.size
    return x.narrow(dim, group.rank * n, n)


def shard_batch(batch, group: Group, shard_rays: bool = False):
    """This rank's share of a global ``(images, (origin, direction,
    points))`` batch: images ``[r B, (r + 1) B)`` of the leading axis,
    ``B = batch / world``, or with ``shard_rays`` height band ``r`` of
    every image (`data_parallel.py:78-101`)."""
    dim = 1 if shard_rays else 0
    images, rays = batch
    return (_share(images, group, dim),
            tuple(_share(x, group, dim) for x in rays))


def _band(rays, group: Group):
    return tuple(_share(x, group, 1) for x in rays)


def replicate(tree, group: Group):
    """Rank 0's tensors on every rank: each tensor leaf of ``tree`` (dicts,
    lists, tuples and named tuples; other leaves are left as they are)
    broadcast in place. Returns ``tree``."""
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(v, group)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, group)
    elif torch.is_tensor(tree):
        group.broadcast_(tree)
    return tree


def sharded_train_step(group: Group, optimizer, config: NeRFConfig,
                       ray_chunks: int, loss_fn=None, occupancy=None,
                       debug_grads: bool = False):
    """The per-rank train step (`data_parallel.py:131-160`):
    ``step(state, batch_share, fine_draws, occ_grid=None)`` with this
    rank's share of the batch (:func:`shard_batch`, either layout) and its
    own draws; the gradients are averaged over the group before the
    optimizer, so every rank returns the same state and metrics."""
    def step(state, batch, fine_draws, occ_grid=None):
        return engine.train_step(
            state, batch, fine_draws, optimizer, config, ray_chunks,
            loss_fn=loss_fn, occupancy=occupancy, occ_grid=occ_grid,
            group=group, debug_grads=debug_grads)
    return step


def sharded_eval_step(group: Group, config: NeRFConfig, ray_chunks: int,
                      loss_fn=None, shard_rays: bool = False):
    """The per-rank eval step (`data_parallel.py:163-181`):
    ``eval(state, batch_share, fine_draws)``. Batch-sharded, the mean of
    the ranks' metrics; with ``shard_rays`` the height bands are
    all-gathered into whole images before PSNR and SSIM."""
    def step(state, batch, fine_draws):
        return engine.eval_step(state, batch, fine_draws, config, ray_chunks,
                                loss_fn=loss_fn, group=group,
                                gather_images=shard_rays)
    return step


def _gather_bands(out: dict, group: Group) -> dict:
    return {k: group.all_gather(v, 1) for k, v in out.items()}


def sharded_render(group: Group, config: NeRFConfig, ray_chunks: int,
                   with_weights: bool = True, coarse_image: bool = True,
                   quantized: bool = False):
    """Whole-image render in height bands (`data_parallel.py:184-218`):
    ``render(coarse_params, fine_params, rays, fine_draws[, packed_q])``
    takes the whole images' rays, renders band ``rank`` of them with this
    rank's draws (a generator, or one tensor per chunk of the band) and
    returns the ``(coarse, fine)`` dicts of whole images, gathered. No
    collective runs inside the render; ``quantized`` takes the int8 dicts
    of ``engine.quantize_render_params``, the same on every rank."""
    def render(coarse_params, fine_params, rays, fine_draws, packed_q=None):
        if quantized and packed_q is None:
            raise ValueError("a quantized render needs packed_q")
        outs = engine.render_image_batch(
            coarse_params, fine_params, _band(rays, group), fine_draws,
            config, ray_chunks, with_weights=with_weights,
            coarse_image=coarse_image,
            packed_q=packed_q if quantized else None)
        return tuple(_gather_bands(o, group) for o in outs)
    return render


def sharded_render_occ(group: Group, config: NeRFConfig, ray_chunks: int,
                       near: float = 2.0, far: float = 6.0,
                       n_samples: int = 64, n_probe: int = 64, aabb=None,
                       quantized: bool = False):
    """The occupancy render (fine model alone, empty space skipped) in
    height bands like :func:`sharded_render` (`data_parallel.py:221-259`):
    ``render(fine_params, rays, occ_grid, fine_draws[, packed_q])`` with
    the grid the same on every rank; ``quantized`` takes the fine model's
    int8 dict. Returns ``{"image", "depth"}`` of whole images."""
    from keras_nerf_tpu_torch.ops import occupancy as occ_mod

    if aabb is None:
        aabb = occ_mod.DEFAULT_AABB

    def render(fine_params, rays, occ_grid, fine_draws, packed_q=None):
        if quantized and packed_q is None:
            raise ValueError("a quantized render needs packed_q")
        out = occ_mod.render_image_batch_occ(
            fine_params, _band(rays, group), occ_grid, fine_draws, config,
            near=near, far=far, n_samples=n_samples, n_probe=n_probe,
            ray_chunks=ray_chunks, aabb=aabb,
            packed_q=packed_q if quantized else None)
        return _gather_bands(out, group)
    return render


def world_size(num_gpus: int, device) -> int:
    """The ranks of ``--num_gpus`` (`train.py:47-49`): ``num_gpus`` itself,
    or every visible card for 0 (one rank on the CPU). More than the
    visible cards raises."""
    if torch.device(device).type != "cuda":
        return max(1, num_gpus)
    count = torch.cuda.device_count()
    if num_gpus > count:
        raise ValueError(f"--num_gpus {num_gpus} but only {count} card(s) "
                         f"are visible")
    return num_gpus if num_gpus > 0 else count


def _rank_main(fn, args, rank: int, n: int, store_path: str, device,
               n_slices: int, backend: str | None, log_level: int | None):
    """One rank: the logging of a spawned rank (rank 0 at ``log_level``,
    the others warnings only), the group, then ``fn(args, group)``."""
    if log_level is not None:
        import logging

        logging.basicConfig(
            level=log_level if rank == 0 else logging.WARNING,
            format=f"%(asctime)s | rank {rank} | %(name)s | %(levelname)s "
                   f"| %(message)s")
    if torch.device(device).type == "cpu":
        # CPU ranks share the host's cores rather than each taking all.
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    store = dist.FileStore(store_path, n)
    group = make_group(n, backend, rank, store, device=device,
                       n_slices=n_slices)
    try:
        fn(args, group)
    finally:
        group.close()


def run_ranks(fn, args, n: int, device, n_slices: int = 1,
              backend: str | None = None,
              timeout: float | None = None) -> None:
    """``fn(args, group)`` on each of ``n`` ranks, rank ``r`` on
    ``cuda:{r}`` (or the CPU; a device with an index puts every rank
    there, with ``backend="gloo"``): one spawned process a rank meeting at
    a ``FileStore`` in a temporary directory, or this process alone for
    one rank. ``fn`` must be importable (it is pickled by name). A rank
    that fails, or ranks still running after ``timeout`` seconds, stop
    the others, and this raises."""
    import logging
    import os
    import shutil
    import tempfile
    import time

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="knt_group_")
    store_path = os.path.join(tmp, "store")
    level = logging.getLogger().getEffectiveLevel()
    try:
        if n == 1:
            _rank_main(fn, args, 0, 1, store_path, device, n_slices, backend,
                       None)
            return
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn, args, r, n, store_path, device,
                                   n_slices, backend, level))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                for p in procs:
                    p.join(timeout=0.2)
                failed = [p for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(
                        ", ".join(f"{p.name} exited with code {p.exitcode}"
                                  for p in failed))
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(f"the {n} ranks did not finish "
                                       f"within {timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
