"""Multi-host bootstrap over ``torch.distributed`` (the counterpart of
``scalce_tpu/parallel/distributed.py``, which uses ``jax.distributed``).

Blocks are independent, so the hosts share little:

  1. every host calls :func:`init_multihost` (a TCP rendezvous at rank
     0's address),
  2. every host runs ``driver.compress`` with ``n_hosts``/``host_id``
     from :class:`HostTopology`: it encodes its strided share of the
     blocks into a triplet of its own,
  3. :func:`barrier`: every host's triplet is complete,
  4. rank 0 runs ``driver.merge_hosts``, the ordered merge, whose triplet
     is the 1-host run's, byte for byte.

What crosses hosts is host data (a barrier, a 94-cell histogram), so the
process group uses the gloo backend: it runs on hosts without a card,
and when two ranks share one card, which NCCL refuses.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

#: seconds a rendezvous or a collective may wait for the other ranks
TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class HostTopology:
    host_id: int
    n_hosts: int
    n_local_devices: int
    n_global_devices: int


def _multi() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: float = TIMEOUT_S) -> HostTopology:
    """Join the job's gloo process group at ``tcp://coordinator_address``
    (``host:port``) as rank ``process_id`` of ``num_processes`` (nothing
    to join for one process), and return this host's coordinates; the
    devices are the CUDA cards each host sees."""
    if num_processes is not None and num_processes > 1 \
            and not dist.is_initialized():
        if coordinator_address is None or process_id is None:
            raise ValueError("a multi-host job needs the coordinator's "
                             "address and this process's id")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    n_local = torch.cuda.device_count()
    if not _multi():
        return HostTopology(0, 1, n_local, n_local)
    total = torch.tensor([n_local], dtype=torch.int64)
    dist.all_reduce(total)
    return HostTopology(dist.get_rank(), dist.get_world_size(), n_local,
                        int(total[0]))


def barrier(tag: int = 0) -> None:
    """Return once every host has reached the barrier ``tag``: between
    "every host has written its triplet" and "rank 0 merges them".  A
    host at another tag raises on every host.  One process: returns."""
    if not _multi():
        return
    t = torch.tensor([tag, -tag], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if t.tolist() != [tag, -tag]:
        raise RuntimeError(f"barrier {tag}: the hosts are at different "
                           f"barriers ({int(-t[1])} to {int(t[0])})")


def global_quality_histogram(local_hist: np.ndarray) -> np.ndarray:
    """The sum over every host of their int64 quality histograms (the
    identity for one process)."""
    if not _multi():
        return local_hist
    t = torch.from_numpy(np.array(local_hist, np.int64))
    dist.all_reduce(t)
    return t.numpy()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
