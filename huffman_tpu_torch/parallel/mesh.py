"""The data mesh: one rank of `torch.distributed` per device.

Counterpart of `huffman_tpu/parallel/mesh.py`.  JAX's ``shard_map`` over a
global ``Mesh`` becomes SPMD over ranks here: each rank holds only its
local shard (its contiguous range of blocks or tiles) and the replicated
values (tables, certified params, the histogram, the verdict).  The
ordered gather that JAX gets from an output sharding is `gather_shards`.

Every collective here is an ``all_reduce`` (SUM, MIN or MAX), which NCCL
and gloo both take on CUDA and CPU tensors; gloo's ``all_gather`` takes
no CUDA tensor, and several ranks on one card must use gloo, since NCCL
refuses two ranks on one GPU.  JAX's ``PartitionSpec`` (``P``) has no
counterpart, since no array here is global.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ops.ils import resolve_device

__all__ = ["data_mesh", "DataMesh", "Mesh", "DATA_AXIS", "gather_shards"]

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh along ``data``: this rank's place in a process group and
    the device its shard lives on.  ``owns_group`` marks the world-1 group
    that `data_mesh` made for this mesh alone, which `close` shuts down."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    owns_group: bool = False

    @property
    def backend(self) -> str:
        """The group's backend, "nccl" or "gloo"."""
        return self.group.name()

    def close(self) -> None:
        """Shuts down the group `data_mesh` made for this mesh; a group it
        was given (the world's, or one passed in) belongs to the caller."""
        if self.owns_group:
            self.group.shutdown()


Mesh = DataMesh


def data_mesh(n_devices: int | None = None, *, device="cuda",
              group: dist.ProcessGroup | None = None) -> DataMesh:
    """1-D mesh along ``data`` over every rank of ``group`` (default: the
    world), this rank's shard on ``device``.

    In a single process with no process group initialised, the mesh gets
    a world-1 group of its own on an in-process store (nccl for a CUDA
    device, gloo for the CPU), so it runs the sharded paths as one device
    and leaves the process-wide default group alone; `DataMesh.close`
    shuts that group down.  ``device`` resolves as the codecs' entry
    points do: a CUDA device without a card raises.  ``n_devices``, where
    given, must be the group's size (the JAX error where it is more); a
    mesh of fewer ranks takes a group of them
    (`torch.distributed.new_group`)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    owns = group is None and not dist.is_initialized()
    if owns:
        make = dist.ProcessGroupNCCL if dev.type == "cuda" else dist.ProcessGroupGloo
        group = make(dist.HashStore(), 0, 1)
    group = group or dist.group.WORLD
    world = group.size()
    if n_devices is not None and n_devices > world:
        raise ValueError(f"requested {n_devices} devices, only {world} available")
    if n_devices is not None and n_devices < world:
        raise ValueError(f"requested {n_devices} devices of a group of "
                         f"{world}; pass a group of {n_devices} ranks")
    return DataMesh(group=group, rank=group.rank(), size=world, device=dev,
                    owns_group=owns)


def all_reduce(mesh: DataMesh, x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` reduced over the mesh in place ("sum", "min" or "max")."""
    opts = dist.AllreduceOptions()
    opts.reduceOp = getattr(dist.ReduceOp, op.upper())
    mesh.group.allreduce([x], opts).wait()
    return x


def on_mesh(mesh: DataMesh, *xs: torch.Tensor) -> None:
    """Raises unless every tensor lies on the mesh's device: a rank never
    carries on elsewhere (a CPU tensor would run the plain versions)."""
    for x in xs:
        if x.device != mesh.device:
            raise ValueError(f"a tensor on {x.device}, the mesh's device is "
                             f"{mesh.device}")


def gather_shards(mesh: DataMesh, local: torch.Tensor) -> torch.Tensor:
    """The rank-ordered concatenation of every rank's ``local`` (equal
    shapes on all ranks, at least 1-D) along its first axis, on every
    rank: each rank writes its slot of a zero-filled (D, ...) tensor, then
    one SUM."""
    out = torch.zeros((mesh.size, *local.shape), dtype=local.dtype,
                      device=local.device)
    out[mesh.rank] = local
    all_reduce(mesh, out, "sum")
    return out.reshape(-1, *local.shape[1:])
