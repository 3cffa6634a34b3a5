"""Several devices: a batch's rows split over a mesh, the accumulators merged.

Counterpart of ``nadavca_tpu/parallel/sharded.py``. The mesh is an explicit
list of ``torch.device`` values, which may repeat a device. A batch's rows
are split into contiguous blocks, one per mesh position (``P(data)``); each
block is staged on its device (the model and genome tables replicated, one
copy per distinct device) and runs the port's own ``pipeline.align_batch``
there, so a shard launches exactly the kernels of the one-device path. Each
block then scatters through ``call.scatter_values``, shared with
``accumulate_batch``.

Under a process group (``parallel/distributed.py``) each rank holds n
consecutive positions of the mesh (process-major, as the JAX package's
global mesh orders them): its batch is split into its n blocks, and the sums
below become one ``all_reduce`` or ``reduce_scatter_tensor`` a process.

Accumulator layouts, as in the JAX package; each is a list with one tensor
per local position:

* replicated: every position holds the (G, 4) / (G,) / (G, 4) accumulators;
  one sum per batch.
* genome-sharded (large G): position i keeps rows ``[i·G/n, (i+1)·G/n)`` of
  the summed contribution (``psum_scatter``), so no position holds the whole
  genome.
* deferred merge: every position carries a full-genome partial that grows in
  place (``index_add_``, no G-sized temporary per batch); no collective runs
  per batch. :func:`make_merge_fn` sums the partials into either layout
  above, without touching them, at checkpoints and before calling.

Footprint of one accumulator set: G·36 bytes (acc float32 ×4, cov int32,
votes int32 ×4), per position for a replicated set or a deferred partial,
G·36/n for a genome slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig
from .. import call as callmod
from .. import pipeline as pipelinemod
from ..utils.profiling import span
from ..utils.upload import Upload
from . import distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a sharded run. ``devices`` are this process's mesh
    positions in order (a device may repeat). With ``distributed`` the mesh
    spans the process group: every process holds ``len(devices)``
    positions, process r positions ``r·n .. r·n + n - 1``."""

    devices: Tuple[torch.device, ...]
    distributed: bool = False

    @property
    def size(self) -> int:
        """Positions in the whole mesh."""
        n = len(self.devices)
        return dist.process_count() * n if self.distributed else n

    @property
    def first(self) -> int:
        """Mesh index of ``devices[0]``."""
        return dist.process_index() * len(self.devices) if self.distributed else 0


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` positions: ``cuda:0 .. cuda:n-1``
    (default: every card; more than there are raises), or n positions on the
    CPU (default 1)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if not 1 <= n <= have:
            raise ValueError(f"{n} CUDA devices asked for, {have} present")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    n = 1 if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"{n} devices")
    return Mesh((dev,) * n)


def process_mesh(devices: Sequence[torch.device]) -> Mesh:
    """The mesh of a process group: this rank's local devices. Every rank
    must hold as many (a collective checks it: every rank calls this)."""
    devices = tuple(torch.device(d) for d in devices)
    counts = dist.process_allgather(np.asarray([len(devices)], np.int64)).ravel()
    if (counts != len(devices)).any():
        raise ValueError(f"the ranks hold {counts.tolist()} devices each; "
                         "every rank must hold as many")
    return Mesh(devices, distributed=True)


def replicate_tables(mesh: Mesh, tables):
    """{device: the genome's ``SubstTables`` there}, one copy per distinct
    device of the mesh (None stays None)."""
    if tables is None:
        return None
    return {d: tables.to(d) for d in dict.fromkeys(mesh.devices)}


@dataclasses.dataclass
class Block:
    """One mesh position's rows of a batch, staged on its device."""

    device: torch.device
    batch: pipelinemod.Batch      # the row block, on the host
    staged: dict                  # ``pipeline.stage_batch`` of it
    wstart: torch.Tensor          # (R_i,) window starts, contig offsets added
    wlen: torch.Tensor
    strand: torch.Tensor


def shard_batch(mesh: Mesh, batch: pipelinemod.Batch, model, cfg: AlignConfig,
                backend: str, tables=None,
                window_start: Optional[np.ndarray] = None) -> List[Block]:
    """Split ``batch``'s rows into one contiguous block per local position
    and stage each on its device. ``tables``: :func:`replicate_tables`.
    ``window_start`` replaces ``batch.window_start`` in the scatter (the CLI
    adds the contigs' offsets in the concatenated genome). Under a process
    group the batch is this rank's rows only. Span ``nadavca.upload``. Each
    block's copies are one ``utils.upload.Upload``: on a CUDA device they
    run on the device's copy stream and the caller's stream waits for them,
    so the host returns before they finish."""
    n = len(mesh.devices)
    R = batch.x.shape[0]
    if R % n:
        raise ValueError(f"{R} rows do not split over {n} devices")
    wstart = batch.window_start if window_start is None else window_start
    r = R // n
    blocks = []
    with span("nadavca.upload"):
        for i, dev in enumerate(mesh.devices):
            blk = pipelinemod.batch_rows(batch, i * r, (i + 1) * r)
            with Upload(dev) as up:
                staged = pipelinemod.stage_batch(
                    blk, model, cfg, backend, device=dev,
                    subst=None if tables is None else tables[dev], upload=up)
                blocks.append(Block(
                    device=dev, batch=blk, staged=staged,
                    wstart=up.put(np.asarray(wstart[i * r:(i + 1) * r], np.int64)),
                    wlen=up.put(blk.window_len), strand=up.put(blk.strand)))
    return blocks


def _reduce(mesh: Mesh, parts: Sequence[torch.Tensor], scatter: bool) -> List[torch.Tensor]:
    """The sum of one tensor per mesh position, in the layout of each local
    position: all of it (replicated), or its genome slice (``scatter``).
    New tensors; ``parts`` are left as they were.

    The local parts are summed on ``devices[0]`` first. Under a process
    group one collective a process follows, on that one tensor: torch's
    process groups take one device a rank, so the several local tensors of
    a rank cannot enter a collective together as XLA's psum takes them.
    Replicated, the ``all_reduce``'s sum is copied to every local device;
    genome-sharded, the ``reduce_scatter`` leaves this process its n
    consecutive slices (rows ``first·G/size`` on), split one a device."""
    dev0 = mesh.devices[0]
    total = parts[0].to(dev0, copy=True)
    for p in parts[1:]:
        total += p.to(dev0)
    if mesh.distributed:
        total = dist.reduce_scatter(total) if scatter else dist.all_reduce(total)
    if not scatter:
        return [total.to(d) for d in mesh.devices]
    rows = total.shape[0] // len(mesh.devices)
    return [total[i * rows:(i + 1) * rows].to(d, copy=True)
            for i, d in enumerate(mesh.devices)]


def _cat(mesh: Mesh, ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """This process's blocks of a per-row result, or its genome slices, in
    order, joined on ``devices[0]``."""
    return torch.cat([t.to(mesh.devices[0]) for t in ts])


def make_sharded_step(mesh: Mesh, cfg: AlignConfig, genome_len: int,
                      genome_sharded: bool = False, with_path: bool = True,
                      merge_deferred: bool = False):
    """The multi-device align + accumulate step:

      step(blocks, acc, cov, votes)
        -> (score, path, acc, cov, votes)        # with_path=True
        -> (score, acc, cov, votes)              # with_path=False

    ``blocks`` from :func:`shard_batch`; the accumulators from
    :func:`make_accumulators_sharded` in the same layout; score and path are
    this process's rows. Per batch the replicated layout sums every
    position's contribution, the genome-sharded one keeps each position's
    slice of that sum, and ``merge_deferred`` adds each block to its
    position's partial in place and communicates nothing (merge with
    :func:`make_merge_fn`). Spans: ``nadavca.step`` around the whole step;
    ``nadavca.merge`` around each block's fresh accumulators and, once more,
    around the sum of the parts into the state (not in the deferred mode)."""
    G = genome_len
    if genome_sharded and G % mesh.size:
        raise ValueError(f"genome_len {G} not divisible by mesh size {mesh.size}")

    def step(blocks, acc, cov, votes):
        with span("nadavca.step"):
            outs = [pipelinemod.align_batch(b.batch, None, cfg, staged=b.staged)
                    for b in blocks]
            if merge_deferred:
                for b, o, a, c, v in zip(blocks, outs, acc, cov, votes, strict=True):
                    callmod.accumulate_batch_(a, c, v, o["base_loglik"], b.wstart,
                                              b.wlen, b.strand, cfg)
            else:
                parts = []
                for b, o in zip(blocks, outs, strict=True):
                    with span("nadavca.merge"):
                        z = callmod.make_accumulators(G, with_votes=True,
                                                      device=b.device)
                    parts.append(callmod.accumulate_batch(
                        z[0], z[1], o["base_loglik"], b.wstart, b.wlen, b.strand,
                        votes=z[2], cfg=cfg))
                with span("nadavca.merge"):
                    acc, cov, votes = (
                        [x + d for x, d in zip(
                            state, _reduce(mesh, [p[j] for p in parts], genome_sharded),
                            strict=True)]
                        for j, state in enumerate((acc, cov, votes)))
            score = _cat(mesh, [o["score"] for o in outs])
            if with_path:
                return score, _cat(mesh, [o["path"] for o in outs]), acc, cov, votes
            return score, acc, cov, votes

    return step


def make_sharded_align(mesh: Mesh, cfg: AlignConfig):
    """The align-only step of ``cli align --devices N``: blocks -> score and
    path of this process's rows, joined on ``devices[0]``. No rescore: the
    alignment files hold the segments only."""

    def step(blocks):
        with span("nadavca.step"):
            outs = [pipelinemod.align_batch(b.batch, None, cfg, staged=b.staged,
                                            rescore=False) for b in blocks]
            return {k: _cat(mesh, [o[k] for o in outs]) for k in ("score", "path")}

    return step


def make_accumulators_sharded(mesh: Mesh, genome_len: int,
                              genome_sharded: bool = False,
                              merge_deferred: bool = False, state=None):
    """Zeroed accumulators in the layout of :func:`make_sharded_step`, each
    allocated on its own position's device: (acc, cov, votes), each a list
    of one tensor per local position.

    ``state``: a restored (acc (G, 4), cov (G,), votes (G, 4)) numpy
    triple to start from instead of zeros. Replicated, every position gets
    it; genome-sharded, its slice; deferred, position 0's partial is seeded
    with it and the other partials start at zeros (the merge sums them)."""
    G = genome_len
    n = mesh.size
    rows = G // n if genome_sharded and not merge_deferred else G
    out = ([], [], [])
    for i, dev in enumerate(mesh.devices, start=mesh.first):
        for j, (lst, tail, dtype) in enumerate(zip(
                out, ((4,), (), (4,)), (torch.float32, torch.int32, torch.int32))):
            if state is None or (merge_deferred and i != 0):
                lst.append(torch.zeros((rows,) + tail, dtype=dtype, device=dev))
                continue
            s = np.asarray(state[j])
            if rows != G:
                s = s[i * rows:(i + 1) * rows]
            # a copy: the partials grow in place, the caller's arrays must not
            lst.append(torch.tensor(s, dtype=dtype, device=dev))
    return out


def make_merge_fn(mesh: Mesh, genome_len: int, genome_sharded: bool = False):
    """The deferred merge: per-position full-genome partials -> the layout
    the per-batch mode keeps (replicated, or genome slices). Pure: the
    partials are left untouched, so it runs at every checkpoint and again
    before calling, with the same result. Under a process group it is a
    collective."""
    if genome_sharded and genome_len % mesh.size:
        raise ValueError(f"genome_len {genome_len} not divisible by mesh size {mesh.size}")

    def merge(acc, cov, votes):
        return tuple(_reduce(mesh, parts, genome_sharded) for parts in (acc, cov, votes))

    return merge


def fetch(mesh: Mesh, parts: Sequence[torch.Tensor], genome_sharded: bool = False) -> np.ndarray:
    """One accumulator of a per-batch layout, whole, on the host (under a
    process group a collective when genome-sharded: every process's slices,
    joined in mesh order)."""
    if not genome_sharded:
        return parts[0].cpu().numpy()
    mine = _cat(mesh, parts)
    return dist.fetch_replicated(mine, True) if mesh.distributed else mine.cpu().numpy()
