"""The ``(data, model)`` grid of ranks for sharded inference, over
torch.distributed.

The port of tahoe_tpu/parallel/mesh.py. The JAX package drives a mesh of
devices from one process; here every rank is a process of its own with one
device of its own, PyTorch's model:

- the ``data`` axis splits the rows into contiguous slices: no
  communication;
- the ``model`` axis splits the trees into contiguous shards, whose f32
  margins one all-reduce (sum) over the model group joins: the cross-device
  rendition of the reference's cub::DeviceSegmentedReduce
  (Struct.h:655-659).

Rank ``r = d * model + m``, the order of JAX's ``reshape(data, model)``.
Multi-host entry: call :func:`init_distributed` once a process with the
same rendezvous, then :func:`make_mesh` on every rank.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tahoe_tpu_torch.config import resolve_device


def init_distributed(init_method: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None, device="cuda") -> bool:
    """``torch.distributed.init_process_group`` for this process.

    A no-op when ``num_processes`` is None, as the JAX wrapper is for one
    process; a group of one is initialized when asked for (``num_processes
    = 1``), so that a one-rank NCCL group runs the code a larger one does.
    ``init_method`` is ``tcp://host:port``, ``file:///path`` or, as the
    JAX package's coordinator is given, ``host:port``. The backend is NCCL
    for a CUDA ``device`` and gloo on the CPU unless ``backend`` says
    otherwise (NCCL refuses two ranks on one card: such ranks take gloo).
    Returns whether a group was initialized."""
    if num_processes is None:
        return False
    if init_method is None or process_id is None:
        raise ValueError("a process group needs its rendezvous (init_method) "
                         "and this process's id")
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, model)`` grid.

    - ``data`` x ``model``: the grid; ``rank``, its coordinates ``d`` and
      ``m`` (``rank = d * model + m``);
    - ``device``: this rank's device;
    - ``model_group`` / ``data_group``: the ranks that share this rank's
      rows (and sum their trees' margins) and those that share its trees
      (and gather their rows), or None where the axis has one rank;
    - ``backend``: the process group's, which decides where a gather runs
      (sharded.py)."""

    data: int
    model: int
    rank: int
    d: int
    m: int
    device: torch.device
    model_group: object = None
    data_group: object = None
    backend: str | None = None


def make_mesh(data: int = 1, model: int = 1, *, device="cuda") -> Mesh | None:
    """The ``(data, model)`` grid over the first ``data * model`` ranks of
    the process group (or this process alone, when none is initialized).

    Every rank calls ``new_group`` for every group, in one order, as
    torch.distributed requires; so every rank of the group calls this with
    the same arguments. A rank past the grid gets None. ``device``:
    ``cuda`` takes card ``rank % device_count`` (one a rank where the node
    has as many; all ranks on one card where it has one), ``cpu`` the host.
    Fewer ranks than the grid raises ValueError, as in JAX."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1; got ({data}, {model})")
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    rank = dist.get_rank() if live else 0
    need = data * model
    if world < need:
        raise ValueError(f"need {need} ranks, have {world}")
    model_groups, data_groups = [None] * data, [None] * model
    if live:
        for d in range(data):
            model_groups[d] = dist.new_group([d * model + m for m in range(model)])
        for m in range(model):
            data_groups[m] = dist.new_group([d * model + m for d in range(data)])
    if rank >= need:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(dev)
    d, m = divmod(rank, model)
    return Mesh(data=data, model=model, rank=rank, d=d, m=m, device=dev,
                model_group=model_groups[d] if model > 1 else None,
                data_group=data_groups[m] if data > 1 else None,
                backend=dist.get_backend() if live else None)
