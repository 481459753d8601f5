"""The (tiles, samples) mesh over a torch.distributed process group (port of
raytracer_tpu/parallel/mesh.py).

The JAX package lays a `jax.sharding.Mesh` over devices; here one rank is
one process on one device, and a `Mesh` is this rank's place in a grid of
ranks:

* `tiles`: image tiles (data parallel over pixels);
* `samples`: the spp budget (sample parallel; ranks on one tile trace the
  same pixels under different sample ids).

Ranks are ordered by node, then by local rank, so each row of the grid (one
tile's sample ranks) stays inside a node whenever sample_parallel is at most
the ranks per node: the per-pixel reductions over the samples axis then ride
NVLink, and only tile assembly and gradient sums cross nodes.

`init_group` starts the default process group, from the environment that
`torchrun` sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK), from
an explicit coordinator, or as a group of one rank; `close_group` ends it.
The backend is NCCL for CUDA and gloo for the CPU unless the caller names
one; a backend that fails to start raises, and no other is tried. The JAX
package's `ray_sharding` and `replicated` (NamedShardings) have no torch
counterpart: a rank's block of a flat lane axis is render/driver.py's
`lane_block`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def init_group(device="cuda", *, backend: str | None = None, coordinator: str | None = None,
               process_id: int | None = None, num_processes: int | None = None) -> torch.device:
    """Start the default process group and return this rank's device.

    The group comes from `coordinator` ("host:port"), `process_id` and
    `num_processes` when a coordinator is given; else from the environment
    when it has RANK and WORLD_SIZE (`torchrun`); else it is a group of one
    rank, rendezvousing in process. A CUDA device is `local_card`'s, made
    current before the group starts, and a CUDA request without a card
    raises. `backend` defaults to "nccl" on CUDA and "gloo" on the CPU;
    NCCL's communicator is created here by a one-element all-reduce, so
    start-up is paid in this call."""
    if coordinator is not None and (process_id is None or num_processes is None):
        raise ValueError("a coordinator needs process_id and num_processes")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA requested but torch.cuda.is_available() is false")
        rank = process_id if coordinator is not None else os.environ.get("RANK")
        dev = torch.device("cuda", local_card(None if rank is None else int(rank),
                                              torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=process_id,
                                world_size=num_processes)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    dist.all_reduce(torch.zeros(1, device=dev))
    return dev


def local_card(rank: int | None, cards: int) -> int:
    """The card index of a rank on its host: LOCAL_RANK when the
    environment has it (torchrun sets it); else, for a rank of a group
    (`rank` given: a coordinator's process_id, or the environment's RANK),
    the rank modulo the host's `cards`, so ranks started one by one on one
    host each take their own card; else 0 (a group of one)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return 0 if rank is None else rank % max(cards, 1)


def close_group() -> None:
    """End the default process group, when one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (tiles, samples) grid of the group's ranks.

    `position` is the rank's index in the grid, tiles-major: tile
    position // samples, sample slot position % samples. Random streams and
    sample budgets key on the position, never on the rank, so an image
    depends on the seed and the mesh shape alone. `sample_group` holds the
    ranks of this rank's tile, `tile_group` those of its sample slot (None
    where the axis has one rank: no collective runs over it)."""

    shape: tuple[int, int]
    position: int
    ranks: tuple[int, ...]  # the group rank at each position
    device: torch.device  # where this rank renders; its collectives' tensors live here
    backend: str
    sample_group: object = None
    tile_group: object = None
    axis_names: tuple[str, str] = (TILE_AXIS, SAMPLE_AXIS)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def tile_index(self) -> int:
        return self.position // self.shape[1]

    @property
    def sample_index(self) -> int:
        return self.position % self.shape[1]


def _node_key() -> tuple[int, int]:
    """(node, local rank) of this process: GROUP_RANK (torchrun's node
    rank), else rank // LOCAL_WORLD_SIZE, else the rank itself (one rank a
    node); LOCAL_RANK, else 0."""
    rank = dist.get_rank()
    if "GROUP_RANK" in os.environ:
        node = int(os.environ["GROUP_RANK"])
    elif "LOCAL_WORLD_SIZE" in os.environ:
        node = rank // int(os.environ["LOCAL_WORLD_SIZE"])
    else:
        node = rank
    return node, int(os.environ.get("LOCAL_RANK", 0))


def make_mesh(n_devices: int | None = None, sample_parallel: int = 1, *,
              device=None) -> Mesh:
    """The (n_devices // sample_parallel, sample_parallel) mesh over the
    initialised default group; a collective, so every rank calls it.

    A mesh spans every rank of the group: `n_devices` (default the world
    size) larger than the group, not a multiple of `sample_parallel`, or
    smaller than the group raises ValueError. `device` is this rank's
    render device (default: the current CUDA device under NCCL, else the
    CPU); gloo may render on CUDA, its collectives taking CUDA tensors."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (init_group)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested n_devices={n_devices} but only {world} available")
    if n_devices % sample_parallel != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by sample_parallel={sample_parallel}")
    if n_devices < world:
        raise ValueError(f"a mesh spans every rank: n_devices={n_devices} of {world}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    keys = torch.tensor([*_node_key(), dist.get_rank()], dtype=torch.int64, device=device)
    gathered = [torch.empty_like(keys) for _ in range(world)]
    dist.all_gather(gathered, keys)
    ranks = tuple(int(k[2]) for k in sorted(gathered, key=lambda k: k.tolist()))
    position = ranks.index(dist.get_rank())
    tiles, samples = n_devices // sample_parallel, sample_parallel
    # Every rank creates every group, in one order (torch.distributed.new_group).
    groups = {}
    if samples > 1:
        for t in range(tiles):
            members = list(ranks[t * samples:(t + 1) * samples])
            groups[("samples", t)] = dist.new_group(members)
    if tiles > 1:
        for s in range(samples):
            groups[("tiles", s)] = dist.new_group(list(ranks[s::samples]))
    return Mesh(shape=(tiles, samples), position=position, ranks=ranks, device=device,
                backend=backend, sample_group=groups.get(("samples", position // samples)),
                tile_group=groups.get(("tiles", position % samples)))


def multihost_mesh(sample_parallel: int | None = None, *, device=None) -> Mesh:
    """The mesh of a multi-node run: tiles across nodes, samples across
    each node's ranks (LOCAL_WORLD_SIZE, default 1) unless
    `sample_parallel` is given."""
    if sample_parallel is None:
        sample_parallel = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return make_mesh(None, sample_parallel, device=device)
