"""The (rays, prims) process mesh of the multi-device renderer (port of
:mod:`rtgs_tpu.parallel.mesh`).

  * ``rays``  — screen tiles data-parallel: each rays-rank renders a slice
    of the tiles; its forward needs no communication, its gradient is
    summed over the rays axis.
  * ``prims`` — the splats sharded: each prims-rank holds one shard, and a
    render passes the shards round a ring (stationary rays, rotating
    splats, an online depth-ordered merge).

Where the JAX package lays a grid of devices out in one program
(``shard_map``), the port runs one process per cell of the grid in one
``torch.distributed`` world: the rank of cell (r, p) is ``r · n_prims +
p``. Each rays-row is one process group (the prims ring), each
prims-column another (the rays axis). CUDA tensors go over ``nccl``, CPU
tensors over ``gloo``; each rank's card is ``cuda:<local rank>``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

RAYS_AXIS = "rays"
PRIMS_AXIS = "prims"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's cell of an ``n_rays × n_prims`` mesh.

    Attributes:
      n_rays, n_prims: the grid.
      rank: this process's rank in the world (``rays_rank · n_prims +
        prims_rank``).
      device: where this rank's tensors live.
      prims_group: the process group of this rank's rays-row (the ring),
        None in a single-process run.
      rays_group: the process group of this rank's prims-column, None in a
        single-process run.
    """

    n_rays: int
    n_prims: int
    rank: int
    device: torch.device
    prims_group: object = None
    rays_group: object = None

    @property
    def shape(self) -> dict:
        return {RAYS_AXIS: self.n_rays, PRIMS_AXIS: self.n_prims}

    @property
    def rays_rank(self) -> int:
        return self.rank // self.n_prims

    @property
    def prims_rank(self) -> int:
        return self.rank % self.n_prims

    def prims_peer(self, offset: int) -> int:
        """World rank of the prims-rank ``offset`` steps along the ring."""
        return (self.rays_rank * self.n_prims
                + (self.prims_rank + offset) % self.n_prims)


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def rank_device(device="cuda", rank: int | None = None) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` (``LOCAL_RANK``, else the
    world rank modulo the cards) when ``device`` is CUDA, else ``device``.
    Raises when CUDA is asked for and there is none."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available")
    if device.index is not None:
        return device
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", _local_rank(rank))


def make_mesh(n_rays: int = 0, n_prims: int = 1, device="cuda") -> Mesh:
    """Build this process's cell of a ``(rays, prims)`` mesh over the
    ``torch.distributed`` world (one process when it is not initialized).

    ``n_rays = 0`` puts all remaining processes on the rays axis. Raises
    ``ValueError`` when the processes do not divide by ``n_prims`` or are
    too few, as the JAX function does for devices, and also when they are
    too many: each process must hold a cell. Every rank must call it with
    the same arguments (it creates the row and column groups collectively).
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_rays == 0:
        if n % n_prims:
            raise ValueError(f"{n} devices not divisible by prims={n_prims}")
        n_rays = n // n_prims
    if n_rays * n_prims > n:
        raise ValueError(
            f"mesh {n_rays}x{n_prims} needs {n_rays * n_prims} devices, "
            f"have {n}")
    if n_rays * n_prims < n:
        raise ValueError(
            f"mesh {n_rays}x{n_prims} covers {n_rays * n_prims} of {n} "
            "processes; each process must hold one cell")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = rank_device(device, rank)
    if not dist.is_initialized():
        return Mesh(n_rays, n_prims, 0, dev)
    prims_group = rays_group = None
    for r in range(n_rays):      # every rank creates every group, in order
        grp = dist.new_group([r * n_prims + p for p in range(n_prims)])
        if r == rank // n_prims:
            prims_group = grp
    for p in range(n_prims):
        grp = dist.new_group([r * n_prims + p for r in range(n_rays)])
        if p == rank % n_prims:
            rays_group = grp
    return Mesh(n_rays, n_prims, rank, dev, prims_group, rays_group)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device="cuda") -> None:
    """Join the ``torch.distributed`` world (the counterpart of
    ``jax.distributed.initialize``), after which :func:`make_mesh` spans
    every process.

    ``coordinator``: ``host:port`` (a TCP store that rank 0 serves) or an
    init-method URL (``tcp://...``, ``file://...``). Arguments left None
    fall back to torch's own environment variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the coordinator, ``WORLD_SIZE`` and ``RANK``, which
    the port's launcher (:mod:`rtgs_tpu_torch.parallel.launcher`) sets for
    each worker. The backend is ``nccl`` when ``device`` is CUDA (each rank
    takes ``cuda:<local rank>``; raises without CUDA) and ``gloo``
    otherwise. Call once per process."""
    dev = torch.device(device)
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator is None:
        init = "env://"
    elif "://" in coordinator:
        init = coordinator
    else:
        init = f"tcp://{coordinator}"
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, process_id))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def mesh_from_config(cfg, device="cuda") -> Mesh:
    """The mesh a :class:`rtgs_tpu_torch.config.MeshConfig` asks for."""
    return make_mesh(cfg.rays, cfg.prims, device)
