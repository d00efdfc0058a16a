"""Process groups for data-parallel training and sharded eval: the
distributed half of segclip_tpu/utils/jax_setup.py, with torch.distributed.

`init_distributed` starts the group from, in this order:
  - the `--dist-coordinator/--dist-num-processes/--dist-process-id` flags
    of the CLIs;
  - the SEGCLIP_DIST_COORDINATOR / SEGCLIP_DIST_NPROCS / SEGCLIP_DIST_PROCID
    triple;
  - SEGCLIP_DIST=1: torchrun's variables (MASTER_ADDR/MASTER_PORT, RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE), the counterpart of JAX's
    cluster auto-detection.
With none of them set it starts nothing, and the world is one process.

The coordinator is HOST:PORT (a TCP rendezvous, rank 0 listens) or any
init_method URL (`tcp://…`, `file:///shared/path`). SEGCLIP_DIST_INIT_TIMEOUT
(seconds, default 300) bounds the rendezvous and every collective.

Devices and backend: on the card each rank takes cuda:(local rank), the
local rank being LOCAL_RANK or else the process id, modulo the cards. The
backend is NCCL when every rank of a host has a card of its own, and gloo
otherwise: on the CPU, or when ranks share a card (NCCL refuses two ranks on
one device). Gloo's collectives here go through host copies of CUDA
tensors (`all_reduce_`), so one code path serves both backends.

The data × model rank grid of tensor parallelism (`init_grid`, the
counterpart of segclip_tpu/parallel/gspmd.py's `make_dp_tp_mesh`): rank r
sits at data index r // tp and model index r % tp, as the JAX mesh's
reshape puts device r. A model row (the tp ranks of one data index) holds
one replica of the model, sharded; a data column (the ranks of one model
index) holds the same shard of every replica. `data_group()` and
`model_group()` are the process groups of this rank's column and row, and
`data_rank/_size`, `model_rank/_size` its place in them; with no grid the
data group is the whole world and the model group this rank alone.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from segclip_tpu_torch.utils.device import resolve_device
from segclip_tpu_torch.utils.logging import get_logger

DEFAULT_INIT_TIMEOUT_S = 300


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


class _Grid:
    """This rank's data column and model row: their groups, ranks, sizes."""

    def __init__(self, tp: int):
        world, me = world_size(), rank()
        dp = world // tp
        # every rank creates every group, in the same order (new_group is a
        # collective over the whole world)
        rows = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
        cols = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
        self.data_rank, self.model_rank = divmod(me, tp)
        self.data_size, self.model_size = dp, tp
        self.data_group, self.model_group = cols[self.model_rank], rows[self.data_rank]


_grid: Optional[_Grid] = None


def init_grid(tp: int) -> None:
    """Split the world into world // tp data indices × tp model indices
    (module docstring); tp = 1 leaves no grid. Raises when tp does not
    divide the world size. Every rank must call it."""
    global _grid
    world = world_size()
    if tp < 1 or world % tp:
        raise ValueError(f"train.tensor_parallelism={tp} must divide the world size "
                         f"({world})")
    _grid = _Grid(tp) if tp > 1 else None


def data_group():
    """The process group of this rank's data column; None (the world) with no grid."""
    return _grid.data_group if _grid else None


def model_group():
    """The process group of this rank's model row; None with no grid: then
    there is no model row (None does not stand for the world here)."""
    return _grid.model_group if _grid else None


def data_rank() -> int:
    return _grid.data_rank if _grid else rank()


def data_size() -> int:
    return _grid.data_size if _grid else world_size()


def model_rank() -> int:
    return _grid.model_rank if _grid else 0


def model_size() -> int:
    return _grid.model_size if _grid else 1


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(device: Optional[str] = None, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> torch.device:
    """Start the process group when configured (see the module docstring)
    and return this rank's device; with nothing configured, the device
    `device` names (`utils/device.resolve_device`). Raises when the settings
    are incomplete or the rendezvous fails."""
    env = os.environ
    coordinator = coordinator or env.get("SEGCLIP_DIST_COORDINATOR")
    if num_processes is None and "SEGCLIP_DIST_NPROCS" in env:
        num_processes = int(env["SEGCLIP_DIST_NPROCS"])
    if process_id is None and "SEGCLIP_DIST_PROCID" in env:
        process_id = int(env["SEGCLIP_DIST_PROCID"])
    local_rank = local_world = None
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--dist-coordinator needs --dist-num-processes and "
                             "--dist-process-id (or SEGCLIP_DIST_NPROCS/_PROCID)")
        init_method = _init_method(coordinator)
    elif env.get("SEGCLIP_DIST") == "1":
        try:
            num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
            local_rank = int(env["LOCAL_RANK"])
        except KeyError as e:
            raise ValueError(f"SEGCLIP_DIST=1 reads torchrun's variables; {e} is "
                             f"not set") from None
        local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
        init_method = "env://"
    elif num_processes is not None or process_id is not None:
        raise ValueError("--dist-num-processes/--dist-process-id need "
                         "--dist-coordinator")
    else:
        return resolve_device(device)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} out of range for "
                         f"{num_processes} processes")
    local_rank = process_id if local_rank is None else local_rank
    local_world = num_processes if local_world is None else local_world

    dev = resolve_device(device)
    chosen, why = "gloo", "on the CPU"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if dev.index is None:
            dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        if local_world <= cards:
            chosen, why = "nccl", f"one card per rank ({local_world} ranks, {cards} cards)"
        else:
            why = f"{local_world} ranks share {cards} card(s); NCCL refuses that"
    timeout = int(env.get("SEGCLIP_DIST_INIT_TIMEOUT", DEFAULT_INIT_TIMEOUT_S))
    dist.init_process_group(chosen, init_method=init_method, world_size=num_processes,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    get_logger().info("process group: rank %d of %d, backend %s (%s), device %s",
                      process_id, num_processes, chosen, why, dev)
    return dev


def shutdown() -> None:
    """Destroy the process group and the grid, if they were started."""
    global _grid
    _grid = None
    if is_initialized():
        dist.destroy_process_group()


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def wire_device() -> str:
    """The device type the backend's collectives take."""
    return "cuda" if backend() == "nccl" else "cpu"


def _size(group) -> int:
    return world_size() if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` across the ranks of `group` (None: the world), in place, and
    return it. Under gloo a CUDA tensor goes through a host copy; under NCCL
    a CPU tensor through a copy on this rank's card."""
    if _size(group) == 1:
        return t
    if t.device.type == wire_device():
        dist.all_reduce(t, group=group)
        return t
    buf = t.to(wire_device())
    dist.all_reduce(buf, group=group)
    return t.copy_(buf)


def all_gather(t: torch.Tensor, group=None) -> list:
    """`t` of every rank of `group` (None: the world), in group rank order,
    on `t`'s device; every rank must give the same shape."""
    if _size(group) == 1:
        return [t]
    buf = t.to(wire_device()).contiguous()
    out = [torch.empty_like(buf) for _ in range(_size(group))]
    dist.all_gather(out, buf, group=group)
    return [o.to(t.device) for o in out]


def broadcast_float(value: float, src: int = 0) -> float:
    """`value` on rank `src`, on every rank."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=wire_device())
    dist.broadcast(t, src=src)
    return float(t.item())


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def warmup() -> None:
    """One small all-reduce and a barrier while every rank is at the same
    point: the first collective pays the communicators' set-up, and it must
    not be the first training step, behind each rank's worker spawn and
    first-batch decode (segclip_tpu/train/loop.py:153-160). With a grid,
    one over each of this rank's groups too."""
    if world_size() > 1:
        all_reduce_(torch.zeros(1))
        if _grid:
            all_reduce_(torch.zeros(1), _grid.data_group)
            all_reduce_(torch.zeros(1), _grid.model_group)
        barrier()
