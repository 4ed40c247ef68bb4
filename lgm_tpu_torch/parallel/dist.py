"""Multi-GPU training: a world of dp x vp ranks over ``torch.distributed``.

Port of ``lgm_tpu/parallel/mesh.py`` (ref: main.py:18-22,82-84, the
reference's Accelerate DDP over NCCL; SURVEY.md §5.8):

- ``init_world`` (``make_mesh``): the world ``torchrun`` describes in its
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``), NCCL on CUDA and gloo on the CPU, laid out as lgm_tpu's
  (dp, vp) device grid: rank = dp_rank * vp + vp_rank, with a process
  group along each axis. Without ``WORLD_SIZE`` it is one process and no
  group.
- ``shard_batch``: the rank's part of a global batch by lgm_tpu's rule:
  every array of fewer than 2 dims split over dp on axis 0 only, every
  other array over dp on axis 0 and over vp on axis 1, the view axis
  (``input`` too where vp divides its views, ``shards_input``). Rank v
  of a vp group holds views v·V/vp … (v+1)·V/vp − 1 of every scene.
- The view-sharded U-Net (lgm_tpu's ``constrain_views`` and
  ``gather_gaussians``): each vp rank runs the U-Net's convolutions on
  its own input views only; at each cross-view attention the rank's
  queries attend to the keys and values of every rank's views, gathered
  over the vp group (``ops/mha.py::mha_views``, or ``gather_views`` on
  the dense route); the Gaussians are gathered the same way before
  rendering, and each rank renders and takes the loss on its own slice
  of the supervision views. ``gather_views`` is the all-gather of a
  token or Gaussian axis in vp rank order, whose backward is the f32 sum
  reduce-scatter: with DistributedDataParallel's mean over the world,
  the gradient is the one-process gradient. Where vp does not divide the
  input views, every vp rank runs the whole U-Net, as ``constrain_views``
  is a no-op when the axis does not divide.
- ``replicate`` is DistributedDataParallel's initial broadcast, in the
  trainer.
- ZeRO-1 (``shard_opt_state``): ``zero1_axis`` picks each large leaf's
  slice of the optimizer state, ``local_slice`` / ``gather_slices`` cut
  and restore it over dp (used by ``train.Optimizer``).
- ``reduce_metrics``: logged scalars as a one-process run computes them.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

# Optimizer-state leaves smaller than this stay replicated under ZeRO-1
# (lgm_tpu's shard_opt_state min_size).
ZERO1_MIN_SIZE = 2 ** 16


@dataclass
class World:
    """This process's place in a (dp, vp) grid of ranks."""

    rank: int = 0
    size: int = 1
    vp: int = 1
    device: torch.device = torch.device("cpu")
    dp_group: Optional[object] = None
    vp_group: Optional[object] = None
    distributed: bool = False

    @property
    def dp(self) -> int:
        return self.size // self.vp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.vp

    @property
    def vp_rank(self) -> int:
        return self.rank % self.vp

    @property
    def is_lead(self) -> bool:
        return self.rank == 0


def init_world(vp: int, device: torch.device) -> World:
    """The world ``torchrun`` launched this process into (a process group
    over NCCL for a CUDA ``device``, gloo otherwise), or one process when
    ``WORLD_SIZE`` is unset. The world size must divide by ``vp``. Under
    torchrun a CUDA rank runs on ``cuda:LOCAL_RANK``, made the current
    device; ``World.device`` is the device the rank runs on."""
    if "WORLD_SIZE" not in os.environ:
        if vp != 1:
            raise ValueError(f"vp={vp} needs a world of a multiple of {vp} "
                             "processes (launch with torchrun)")
        return World(device=device)
    size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if size % vp:
        raise ValueError(f"world size {size} is not a multiple of vp={vp}")
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", rank=rank,
                            world_size=size,
                            device_id=device if cuda else None)
    world = World(rank=rank, size=size, vp=vp, device=device,
                  distributed=True)
    # Every rank creates every group, in the same order.
    for v in range(vp):
        group = dist.new_group([d * vp + v for d in range(world.dp)])
        if world.vp_rank == v:
            world.dp_group = group
    for d in range(world.dp):
        group = dist.new_group([d * vp + v for v in range(vp)])
        if world.dp_rank == d:
            world.vp_group = group
    return world


def close(world: World) -> None:
    if world.distributed:
        dist.destroy_process_group()


def barrier(world: World) -> None:
    if world.distributed:
        dist.barrier()


def _part(x: torch.Tensor, axis: int, parts: int, index: int):
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"into {parts}")
    return x.narrow(axis, index * (n // parts), n // parts)


def shards_input(world: World, n_input_views: int) -> bool:
    """Whether the U-Net runs view-sharded: vp > 1 and vp divides the
    input views (else each vp rank runs all of them)."""
    return world.vp > 1 and n_input_views % world.vp == 0


def views_group(world: World, n_input_views: int):
    """The vp group the view-sharded U-Net gathers over, or None."""
    return world.vp_group if shards_input(world, n_input_views) else None


def shard_views(world: World, batch: Dict[str, torch.Tensor]) -> Dict:
    """The rank's vp slice of the view axis of every per-view array
    (``input``'s where ``shards_input``)."""
    if world.vp == 1:
        return batch
    split_input = "input" in batch and shards_input(world,
                                                     batch["input"].shape[1])
    return {k: v if (k == "input" and not split_input) or v.ndim < 2 else
            _part(v, 1, world.vp, world.vp_rank).contiguous()
            for k, v in batch.items()}


def group_size(group) -> int:
    """The ranks of ``group``; 1 for None (one process)."""
    return 1 if group is None else dist.get_world_size(group)


def gather_axis(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The group's tensors joined along ``axis`` in rank order (an
    all-gather; no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def reduce_scatter_axis(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, in f32, and of it this rank's
    slice along ``axis`` (rank r the r-th of equal slices)."""
    n = dist.get_world_size(group)
    chunks = [c.contiguous() for c in x.float().chunk(n, dim=axis)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _GatherViews(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return gather_axis(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        out = reduce_scatter_axis(g, ctx.axis, ctx.group).to(g.dtype)
        return out, None, None


def gather_views(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The vp ranks' slices of a token or Gaussian axis joined in rank
    order (view order); the backward sums the cotangent over the group in
    f32 and keeps this rank's slice."""
    return _GatherViews.apply(x, axis, group)


def shard_batch(world: World, batch: Dict[str, torch.Tensor]) -> Dict:
    """The rank's part of a global batch: axis 0 over dp, then the view
    axis over vp (``shard_views``)."""
    if world.size == 1:
        return batch
    return shard_views(world, {k: _part(v, 0, world.dp, world.dp_rank)
                               for k, v in batch.items()})


def broadcast_scenes(world: World, batch: Dict[str, torch.Tensor]) -> Dict:
    """The first vp rank's batch on every vp rank of its scenes (in
    place): training samples draw their views and augmentations from
    fresh entropy, so the ranks that share scenes take one copy."""
    if world.vp > 1:
        src = world.dp_rank * world.vp
        for key in sorted(batch):
            dist.broadcast(batch[key], src, group=world.vp_group)
    return batch


def any_rank(world: World, flag: bool) -> bool:
    """Whether ``flag`` is set on any rank."""
    if not world.distributed:
        return flag
    t = torch.tensor([float(flag)], device=world.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def reduce_metrics(world: World, metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, float]:
    """Scalar metrics of the rank's slice -> their value over the global
    batch, as one process computes it: every rank holds an equal slice, so
    a mean is the mean over ranks; ``psnr`` is -10 log10(mse), not linear
    in the mse, so the mse (10^(-psnr / 10)) is averaged and turned back.
    One process: the values as they are."""
    out = {k: float(v) for k, v in metrics.items()}
    if world.size == 1:
        return out
    keys = sorted(out)
    vals = [10.0 ** (-out[k] / 10.0) if k == "psnr" else out[k]
            for k in keys]
    t = torch.tensor(vals, dtype=torch.float64, device=world.device)
    dist.all_reduce(t)
    out = dict(zip(keys, (t / world.size).tolist()))
    if "psnr" in out:
        out["psnr"] = -10.0 * math.log10(out["psnr"])
    return out


def zero1_axis(shape, dp: int) -> Optional[int]:
    """The axis a leaf of ``shape`` shards over dp under ZeRO-1, or None
    (replicated): leaves of at least ``ZERO1_MIN_SIZE`` elements, on their
    largest dp-divisible axis (the first such)."""
    if math.prod(shape) < ZERO1_MIN_SIZE:
        return None
    divisible = [i for i, s in enumerate(shape) if s % dp == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda i: shape[i])


def local_slice(x: torch.Tensor, axis: int, world: World) -> torch.Tensor:
    """This dp rank's slice of ``x`` along ``axis`` (a view)."""
    return _part(x, axis, world.dp, world.dp_rank)


def gather_slices(local: torch.Tensor, axis: int, world: World
                  ) -> torch.Tensor:
    """The dp ranks' slices along ``axis`` joined into the full tensor
    (an all-gather over the rank's dp group)."""
    part = local.movedim(axis, 0).contiguous()
    if world.dp == 1:
        return part.movedim(0, axis)
    full = part.new_empty((world.dp * part.shape[0],) + part.shape[1:])
    dist.all_gather_into_tensor(full, part, group=world.dp_group)
    return full.movedim(0, axis)
