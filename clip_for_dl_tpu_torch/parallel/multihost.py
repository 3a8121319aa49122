"""The multi-process runtime (counterpart of
``clip_for_dl_tpu.parallel.multihost``).

One process drives one device. The processes form a ``torch.distributed``
group: NCCL between cards, gloo between CPU processes. A failure to start
NCCL is an error; nothing falls back to gloo or to the CPU.

- :func:`init_process_group` joins the group (the JAX ``initialize``):
  from the variables ``torchrun`` sets (``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``: the ``env://`` init),
  else from ``--coordinator HOST:PORT`` as ``tcp://HOST:PORT`` with
  ``--num-processes`` and ``--process-id``. It returns the device the
  process drives: ``cuda:LOCAL_RANK``, or the CPU.
- :func:`is_primary` and :func:`sync` gate host-side writes and put a
  barrier around them.
- :func:`process_sharded_loader_kwargs` gives each process its strided
  shard of the data set, as the JAX package's multi-process run loads it.
- :func:`gather_host` and :func:`fetch_global` gather rank-ordered results
  to every rank; :func:`assert_same_across_processes` checks that a
  host-side scalar agrees; :func:`agree_any` makes a flag (a preemption
  signal) true on every process when it is true on one.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("clip_for_dl_tpu_torch.multihost")

# how long a collective may wait for the other processes
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def launched() -> bool:
    """True in a process that ``torchrun`` started."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def torchrun_command(world: int, module: str, args: Sequence[str]) -> List[str]:
    """``python -m module args`` as ranks 0 … world − 1 of a group on this
    host: ``torchrun --standalone`` (a rendezvous on a free port; when a
    rank fails the others are stopped; SIGTERM and SIGINT are passed on)."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={world}", "-m", module, *args]


def init_process_group(coordinator: Optional[str] = None, num_processes: int = 1,
                       process_id: int = 0, device: str = "cuda",
                       timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group; returns the device this process drives.

    ``device`` is ``"cuda"`` (NCCL, one card per process: ``LOCAL_RANK``,
    or ``process_id`` modulo the cards visible) or ``"cpu"`` (gloo)."""
    if launched():
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init = "env://"
    else:
        if not coordinator:
            raise ValueError("a process group needs --coordinator HOST:PORT or torchrun")
        world, rank, local = num_processes, process_id, process_id
        init = f"tcp://{coordinator}"
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    if device == "cuda":
        from ..core.device import require_cuda

        require_cuda()
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=timeout)
    logger.info("joined the %s group as rank %d of %d on %s", backend, rank, world, dev)
    return dev


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def _world() -> int:
    return dist.get_world_size() if is_distributed() else 1


process_index, process_count = _rank, _world


def is_primary() -> bool:
    """True on the process that does the host-side writes."""
    return _rank() == 0


def sync(name: str = "barrier") -> None:
    """A barrier across the processes (nothing on one process); put it
    around checkpoint directory changes."""
    if is_distributed():
        logger.debug("barrier %s", name)
        dist.barrier()


def destroy() -> None:
    if is_distributed():
        dist.destroy_process_group()


def process_sharded_loader_kwargs(global_batch_size: int,
                                  process_index: Optional[int] = None,
                                  process_count: Optional[int] = None) -> Dict[str, int]:
    """HostLoader arguments for this process's strided shard of the data,
    batched at its slice of the global batch (the JAX function)."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    if global_batch_size % pc:
        raise ValueError(f"global batch size {global_batch_size} must divide over "
                         f"{pc} processes")
    return {"batch_size": global_batch_size // pc, "shard_index": pi, "num_shards": pc,
            # equal per-shard batch counts: a skew would leave a rank waiting
            # alone in a collective
            "even_shards": True}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def gather_host(x) -> np.ndarray:
    """Every process's array, concatenated in rank order along the first
    axis, on every process (the rows of each may differ in number)."""
    x = _host(x)
    if not is_distributed():
        return x
    parts = [None] * _world()
    dist.all_gather_object(parts, x)
    return np.concatenate(parts)


def fetch_global(x) -> np.ndarray:
    """A tensor or array as a host array: gathered in rank order when the
    processes form a group (each holds its rows), else as it is."""
    return gather_host(x)


def assert_same_across_processes(value: float, name: str, atol: float = 0.0) -> None:
    """Raises when a host-side scalar differs between the processes (a
    loss after a step: data fed out of step)."""
    if not is_distributed():
        return
    got = gather_host(np.asarray([value], np.float64))
    if not np.allclose(got, got[0], atol=atol, rtol=0.0):
        raise AssertionError(f"{name} differs across processes: {got.tolist()}")


def _flag_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree_any(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any (a preemption
    signal that reached one rank stops them all at the same step)."""
    if not is_distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=_flag_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
