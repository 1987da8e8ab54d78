"""Data parallelism across processes over `torch.distributed`
(counterpart of `mobileposer_tpu/parallel/distributed.py`).

Training runs one process per device, PyTorch's idiom for data-parallel
training, where the JAX package runs one program over a mesh:

  1. each process calls `initialize_distributed()` once (torchrun sets
     the environment; `spawn` does it for one host's devices),
  2. every rank assembles the same global batch from the same seeded
     pipeline and keeps its own rows (`host_local_batch`),
  3. the train step reduces the loss and the gradients across the ranks
     (`train.trainer`), so the optimizer update is the same everywhere.

The collectives run on NCCL between CUDA devices and on gloo on the CPU
(`backend_for`). The backend is the caller's or that rule's, never a
fallback: NCCL refuses two ranks on one card, and a run that wants that
(the one-card rehearsal of `chip_smoke.py`) passes `backend="gloo"`.

The JAX package reads JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID; the port reads torchrun's MASTER_ADDR and MASTER_PORT,
WORLD_SIZE and RANK (and LOCAL_RANK for the device, `local_device`).
"""

from __future__ import annotations

import hashlib
import os
import socket
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mobileposer_tpu_torch.device import resolve_device


def backend_for(device) -> str:
    """NCCL between CUDA devices, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _env_coordinator() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the process group from the arguments or the environment
    (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK). A no-op returning False
    without a coordinator address. `backend` defaults to
    `backend_for(device)` (the CUDA card unless `device` is given)."""
    coordinator_address = coordinator_address or _env_coordinator()
    if coordinator_address is None:
        return False
    # `is None`, not truthiness: an explicit process_id=0 must beat a stale
    # RANK inherited from the environment
    if num_processes is None:
        num_processes = os.environ.get("WORLD_SIZE", 1)
    if process_id is None:
        process_id = os.environ.get("RANK", 0)
    if backend is None:
        backend = backend_for(resolve_device(device))
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_mesh(device=None):
    """The mesh of the process group: entry r is rank r's device (this
    process's is `device`, the CUDA card unless given), gathered from
    every rank."""
    from mobileposer_tpu_torch.parallel.mesh import Mesh
    devices = [None] * world_size()
    dist.all_gather_object(devices, str(resolve_device(device)))
    return Mesh(tuple(torch.device(d) for d in devices))


def local_device() -> torch.device:
    """This process's CUDA device under torchrun: cuda:LOCAL_RANK."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def host_local_batch_slice(global_batch_size: int,
                           process_index: Optional[int] = None,
                           process_count: Optional[int] = None
                           ) -> Tuple[int, int]:
    """(start, size) of this process's rows of a global batch.

    `process_index` / `process_count` default to the live process group.
    The global batch must divide evenly: every rank contributes the same
    number of rows to the collectives."""
    n_proc = world_size() if process_count is None else process_count
    pid = rank() if process_index is None else process_index
    if n_proc <= 0 or not (0 <= pid < n_proc):
        raise ValueError(f"invalid process topology: index {pid} of {n_proc}")
    if global_batch_size % n_proc != 0:
        raise ValueError(
            f"global batch {global_batch_size} does not divide evenly over "
            f"{n_proc} processes; pad the batch or change the process count")
    per = global_batch_size // n_proc
    return pid * per, per


def host_local_batch(batch: dict, process_index: Optional[int] = None,
                     process_count: Optional[int] = None,
                     batch_dim: int = 0) -> dict:
    """This process's rows of a global numpy batch (the counterpart of
    `global_batch_from_host_slices`: there each host hands its slice to
    one global array; here each rank keeps its slice). 1-D arrays
    (`lengths`) slice on their only axis, others on `batch_dim`."""
    probe = next(v for v in batch.values() if np.ndim(v) > 1)
    start, size = host_local_batch_slice(probe.shape[batch_dim],
                                         process_index, process_count)
    out = {}
    for k, v in batch.items():
        d = 0 if np.ndim(v) <= 1 else batch_dim
        idx = [slice(None)] * np.ndim(v)
        idx[d] = slice(start, start + size)
        out[k] = v[tuple(idx)]
    return out


def fold_in(generator: torch.Generator, k: int) -> torch.Generator:
    """A new generator for stream `k` of `generator`'s next draw (the
    counterpart of `jax.random.fold_in`): seeded from the generator's
    state and `k`, after which the generator advances by one draw. Ranks
    that hold equal generators get different, reproducible streams; the
    state is read on the host, so no device is waited for."""
    state = generator.get_state().numpy().tobytes()
    seed = int.from_bytes(hashlib.blake2b(
        state + int(k).to_bytes(8, "little"), digest_size=8).digest(),
        "little") >> 1
    torch.empty(1, device=generator.device).uniform_(generator=generator)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(index: int, fn: Callable, devices: Sequence[str], port: int,
                backend: Optional[str], args: tuple, results) -> None:
    device = torch.device(devices[index])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(f"127.0.0.1:{port}", len(devices), index,
                           backend or backend_for(device))
    try:
        results.put((index, fn(index, device, *args)))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, devices: Sequence, *args,
          backend: Optional[str] = None) -> list:
    """Run `fn(rank, device, *args)` in one process per entry of `devices`
    (a device may repeat), joined in one process group on this host, and
    return the ranks' results in rank order. `fn` must be importable (a
    module-level function) and its result small and picklable (the
    results wait in a pipe until every rank has ended). A failed rank
    raises here."""
    import torch.multiprocessing as mp
    devices = [str(resolve_device(d)) for d in devices]
    results = mp.get_context("spawn").SimpleQueue()
    mp.spawn(_rank_entry, args=(fn, devices, _free_port(), backend, args,
                                results), nprocs=len(devices), join=True)
    out = dict(results.get() for _ in devices)
    return [out[r] for r in range(len(devices))]


def join_or_spawn(entry: Callable, argv: Sequence[str],
                  device: Optional[str] = None) -> Optional[list]:
    """How a training CLI runs on this host, as the JAX manager's default
    mesh spans every device:

      * under torchrun (MASTER_ADDR and MASTER_PORT set), this process
        joins the group as rank RANK, on `device` or cuda:LOCAL_RANK,
        and trains its part: returns None;
      * with no group, no device named and more than one card, one rank
        per card is spawned, each running `entry(rank, device, argv)`
        (the CLI's own main on that card): returns their results;
      * otherwise this process trains alone: returns None."""
    if dist.is_initialized():
        return None
    if _env_coordinator() is not None:
        dev = torch.device(device) if device else local_device()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        initialize_distributed(device=dev)
        return None
    if device is None and torch.cuda.device_count() > 1:
        from mobileposer_tpu_torch.parallel.mesh import make_mesh
        return spawn(entry, make_mesh().devices, list(argv))
    return None


def rank_device(device: Optional[str]):
    """The device a training CLI's process trains on: the one named, or
    under torchrun cuda:LOCAL_RANK, else None (the card)."""
    if device is None and world_size() > 1:
        return local_device()
    return device


def broadcast_from_rank0(value):
    """Rank 0's `value` on every rank (itself without a group)."""
    if world_size() == 1:
        return value
    box = [value if rank() == 0 else None]
    dist.broadcast_object_list(box, 0)
    return box[0]

