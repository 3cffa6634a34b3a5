"""Process groups: processes joined by ``torch.distributed``, each driving
one or more local devices.

Counterpart of ``nadavca_tpu/parallel/distributed.py``. Each process of the
group streams its own shard of the reads (shared-nothing ingest), runs the
sharded step on its local devices, and the accumulators are merged by the
collectives of ``parallel/sharded.py``; process 0 writes the results.

Mesh positions are numbered process-major, as in the JAX package's global
mesh: process r's local device i is position ``r·n + i`` (n local devices a
process), and on CUDA it is ``cuda:((r·n + i) mod cards)``.

Backend rule, decided once by :func:`initialize_distributed`:

- NCCL when the device is CUDA and every position has a card of its own
  (``num_processes · n ≤ torch.cuda.device_count()``);
- gloo otherwise: ranks on the CPU, and positions that share a card. Under
  gloo a collective on a CUDA tensor copies it to the host and back. The
  collectives below choose that copy from the backend the group was started
  with, never by catching a failed collective.

Every collective runs under the group's timeout, so a rank that died makes
the others fail instead of wait forever.

``global_batch_from_local`` and ``global_staged_from_local`` of the JAX
package have no counterpart: each rank runs its own rows on its own device,
so no global array is ever formed.
"""

from __future__ import annotations

import datetime
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the longest a rank waits in one collective for the others
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def choose_backend(device_type: str, num_processes: int, n_local: int = 1) -> str:
    """``"nccl"`` when every mesh position (``n_local`` a process) gets a
    CUDA device of its own, else ``"gloo"``."""
    if device_type == "cuda" and num_processes * n_local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_devices(device_type: str, process_id: int, num_processes: int,
                 n_local: int = 1) -> List[torch.device]:
    """The ``n_local`` devices of rank ``process_id``: position ``r·n + i`` on
    ``cuda:((r·n + i) mod cards)``, so positions have cards of their own
    while there are enough and share them round robin otherwise (gloo); on
    the CPU, n positions on the CPU."""
    if device_type != "cuda":
        return [torch.device(device_type)] * n_local
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("a CUDA rank, but torch sees no CUDA device")
    return [torch.device("cuda", (process_id * n_local + i) % n_cards)
            for i in range(n_local)]


def initialize_distributed(coordinator: str, num_processes: int, process_id: int,
                           device: str = "cuda", n_local: int = 1) -> List[torch.device]:
    """Join the process group at ``coordinator`` (``host:port``; rank 0
    listens there) and return this rank's ``n_local`` devices. Every
    collective of the group waits at most ``COLLECTIVE_TIMEOUT``."""
    if num_processes is None or process_id is None:
        raise ValueError("a process group needs num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range [0, {num_processes})")
    if n_local < 1:
        raise ValueError(f"{n_local} local devices")
    device_type = torch.device(device).type
    devs = rank_devices(device_type, process_id, num_processes, n_local)
    backend = choose_backend(device_type, num_processes, n_local)
    if backend == "nccl":
        # the group's one device of this rank: its collectives run on devs[0]
        torch.cuda.set_device(devs[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=COLLECTIVE_TIMEOUT)
    return devs


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_files_for_process(paths: Sequence[str],
                            process_id: Optional[int] = None,
                            num_processes: Optional[int] = None) -> List[str]:
    """Deterministic round-robin file assignment (shared-nothing ingest)."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return [p for i, p in enumerate(sorted(paths)) if i % n == pid]


def _wire_device(t: torch.Tensor) -> torch.device:
    """Where a collective on ``t`` runs: the host under gloo."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else t.device


def _on_wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` on the wire device, never ``t`` itself:
    the collectives work in place and their inputs stay as they were."""
    return t.to(_wire_device(t), copy=True).contiguous()


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on ``t``'s device."""
    w = _on_wire(t)
    dist.all_reduce(w)
    return w.to(t.device)


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """Rank r's block of the sum over the W ranks: rows ``[r·m/W, (r+1)·m/W)``
    of ``t``'s m rows (``psum_scatter`` over contiguous blocks)."""
    W = dist.get_world_size()
    if t.shape[0] % W:
        raise ValueError(f"{t.shape[0]} rows do not split over {W} ranks")
    w = _on_wire(t)
    out = w.new_empty((t.shape[0] // W,) + tuple(t.shape[1:]))
    with warnings.catch_warnings():
        # newer releases rename it; the old name is the one every release has
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, w)
    return out.to(t.device)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(W, ...) stack of every rank's ``t`` (same shape on every rank), on
    ``t``'s device."""
    w = _on_wire(t)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, w)
    return torch.stack(parts).to(t.device)


def process_allgather(x, tiled: bool = False) -> np.ndarray:
    """Every rank's array, stacked on a new first axis (``tiled``: joined
    along the first axis); counterpart of ``multihost_utils.process_allgather``."""
    a = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(a)
    if dist.get_backend() != "gloo":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    g = all_gather(t).cpu().numpy()
    return g.reshape((-1,) + a.shape[1:]) if tiled else g


def sync_global_devices() -> None:
    """A barrier of every rank."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def fetch_replicated(x: torch.Tensor, sharded: bool = False) -> np.ndarray:
    """The whole accumulator on the host of every rank: ``x`` itself when it
    is replicated; the ranks' genome slices joined in rank order when it is
    genome-sharded (a collective: every rank takes part)."""
    if not sharded:
        return x.cpu().numpy()
    return all_gather(x).reshape((-1,) + tuple(x.shape[1:])).cpu().numpy()
