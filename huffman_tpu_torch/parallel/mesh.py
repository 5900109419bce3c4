"""The data mesh: one rank of `torch.distributed` per device.

Counterpart of `huffman_tpu/parallel/mesh.py`.  JAX's ``shard_map`` over a
global ``Mesh`` becomes SPMD over ranks here: each rank holds only its
local shard (its contiguous range of blocks or tiles) and the replicated
values (tables, certified params, the histogram, the verdict).  The
ordered gather that JAX gets from an output sharding is `gather_shards`.

The collectives are an ``all_reduce`` (SUM, MIN or MAX), which NCCL and
gloo both take on CUDA and CPU tensors, and the ordered gathers'
all-gather into one tensor, where the backend takes the tensor: NCCL, and
gloo on the CPU.  Gloo's all-gather takes no CUDA tensor, and several ranks
on one card must use gloo, since NCCL refuses two ranks on one GPU, so
there a gather is a zero-filled SUM.  Each collective is a span
``coll.<op>`` (attributes ``op``, ``bytes``, the result this rank holds,
and ``world``) and counts ``collectives.<op>`` and ``collective_bytes``,
the bytes of this rank's input and output buffers (`utils/trace.py`).
JAX's ``PartitionSpec`` (``P``) has no counterpart, since no array here is
global.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ops.launch import resolve_device
from ..utils import trace

__all__ = ["data_mesh", "DataMesh", "Mesh", "DATA_AXIS", "gather_shards",
           "gather_ragged"]

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


def _collective(mesh: DataMesh, op: str, x: torch.Tensor, out_bytes: int):
    """The span of one collective, and its counts: the call and the bytes
    of this rank's input (``x``) and output buffers."""
    trace.count("collectives." + op)
    trace.count("collective_bytes", x.numel() * x.element_size() + out_bytes)
    return trace.span("coll." + op, device=x.device, op=op, bytes=out_bytes,
                      world=mesh.size)


def all_reduce(mesh: DataMesh, x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` reduced over the mesh in place ("sum", "min" or "max")."""
    opts = dist.AllreduceOptions()
    opts.reduceOp = getattr(dist.ReduceOp, op.upper())
    with _collective(mesh, "all_reduce", x, x.numel() * x.element_size()):
        mesh.group.allreduce([x], opts).wait()
    return x


def _all_gather(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (at least 1-D) in rank order along its first
    axis, one copy of the bytes moved (the all-gather into one tensor that
    ``dist.all_gather_into_tensor`` runs)."""
    out = torch.empty((mesh.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    opts = dist.distributed_c10d.AllgatherOptions()
    with _collective(mesh, "all_gather", x, out.numel() * out.element_size()):
        mesh.group._allgather_base(out, x, opts).wait()
    return out


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
    rank: one all-gather where the backend takes the tensor (NCCL, gloo on
    the CPU), else each rank writes its slot of a zero-filled (D, ...)
    tensor and one SUM adds them (gloo on a card)."""
    local = local.contiguous()
    if mesh.backend == "nccl" or local.device.type == "cpu":
        return _all_gather(mesh, local)
    out = torch.zeros((mesh.size, *local.shape), dtype=local.dtype,
                      device=local.device)
    out[mesh.rank] = local
    all_reduce(mesh, out, "sum")
    return out.reshape(-1, *local.shape[1:])


def gather_ragged(mesh: DataMesh, local: torch.Tensor) -> torch.Tensor:
    """`gather_shards` of shards whose first dimensions differ (the other
    dimensions equal on all ranks): one all-reduce of the sizes, then the
    gather of each shard padded to the largest, then each trimmed to its
    own."""
    sizes = torch.zeros(mesh.size, dtype=torch.int64, device=local.device)
    sizes[mesh.rank] = local.shape[0]
    all_reduce(mesh, sizes, "sum")
    sizes = trace.to_host(sizes, "gather_sizes").tolist()
    pad = torch.zeros((max(sizes), *local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    pad[: local.shape[0]] = local
    whole = gather_shards(mesh, pad).reshape(mesh.size, *pad.shape)
    return torch.cat([whole[d, :n] for d, n in enumerate(sizes)])
