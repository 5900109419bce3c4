"""Multi-process initialisation of `torch.distributed`.

Counterpart of `huffman_tpu/utils/distributed.py`.  Where the JAX package
joins every host into one global device mesh through ``jax.distributed``,
this port runs one process per card (SPMD over ranks): every process calls
:func:`init_multihost` (idempotent), after which `parallel.data_mesh` spans
all ranks and the sharded entry points of `huffman_tpu_torch.parallel`
run unchanged, their collectives over NCCL between cards (or gloo, which
the CPU tests use).

Typical launch, one process per card (``torchrun --nproc-per-node=N``)::

    from huffman_tpu_torch.utils.distributed import init_multihost
    from huffman_tpu_torch.parallel import data_mesh, make_ils_sharded_roundtrip

    init_multihost()                      # no-op in a single process
    mesh = data_mesh()                    # every rank, on its own card
    step = make_ils_sharded_roundtrip(mesh, k=2048, max_len=16,
                                      tiles_per_device=TPD)
    ...
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["init_multihost", "is_multihost"]


def is_multihost() -> bool:
    """True when the default process group spans more than one process."""
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    local_rank: int | None = None,
    backend: str = "nccl",
    timeout: float | None = None,
) -> None:
    """Initialise the default process group once, from the arguments or
    from the launcher's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, as ``torchrun`` sets them).

    The JAX package's call form: ``coordinator_address`` is ``host:port``,
    as ``jax.distributed`` takes it, and becomes ``tcp://host:port``; an
    address with a scheme (``tcp://``, ``file://``, ``env://``) is passed
    on as it is.  ``num_processes`` and ``process_id`` are the world size
    and this process's rank.  Unlike the JAX package, the port reads
    neither ``JAX_COORDINATOR_ADDRESS`` nor ``TPU_WORKER_HOSTNAMES``.

    Safe to call unconditionally: a no-op when a group exists already, or
    when no multi-process launch is configured (no address and no
    ``MASTER_ADDR``).  ``backend`` is "nccl"
    (the cards) unless the caller asks for "gloo"; with nccl the process
    takes card ``local_rank``.  ``timeout`` (seconds) bounds every
    collective, so a rank that never arrives ends the run with an error
    instead of a hang."""
    if dist.is_initialized():
        return
    env = os.environ
    if not coordinator_address and "MASTER_ADDR" not in env:
        return  # a single process
    if not coordinator_address:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world_size = int(env.get("WORLD_SIZE", 1)) if num_processes is None \
        else num_processes
    rank = int(env.get("RANK", 0)) if process_id is None else process_id
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None \
        else local_rank
    if backend == "nccl":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
