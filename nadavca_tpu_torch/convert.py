"""State carried across from the JAX package: plain numpy in, port objects out.

A test (or a migration script) builds state once with ``nadavca_tpu``, hands
the arrays over through these functions, and both packages then compute on the
same data. This module imports nothing of ``nadavca_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .config import AlignConfig
from .genome import Contig, Genome
from .kmer_model import KmerModel
from .ops.subst_tables import SubstTables
from .pipeline import Batch
from .sched.bands import ChunkedBands


def kmer_model_from_numpy(level_mean, level_std, k: int) -> KmerModel:
    return KmerModel(
        k=int(k),
        level_mean=np.asarray(level_mean, np.float32).copy(),
        level_std=np.asarray(level_std, np.float32).copy(),
    )


def genome_from_codes(contigs: Mapping[str, np.ndarray]) -> Genome:
    """A genome from {contig name: encoded bases (0..3, 4 = N)}."""
    return Genome([Contig(name, np.asarray(codes, np.int8).copy())
                   for name, codes in contigs.items()])


def accumulators_from_numpy(acc, cov, votes=None, device="cuda"):
    """(acc (G, 4) f32, cov (G,) i32[, votes (G, 4) i32]) tensors on ``device``."""
    out = (torch.from_numpy(np.asarray(acc, np.float32).copy()).to(device),
           torch.from_numpy(np.asarray(cov, np.int32).copy()).to(device))
    if votes is None:
        return out
    return out + (torch.from_numpy(np.asarray(votes, np.int32).copy()).to(device),)


def config_from_dict(d: Mapping) -> AlignConfig:
    """An :class:`AlignConfig` from ``dataclasses.asdict`` of either package's
    config. Unknown keys raise, so a field added on one side only is noticed."""
    d = dict(d)
    if "bucket_edges" in d:
        d["bucket_edges"] = tuple(d["bucket_edges"])
    known = {f.name for f in dataclasses.fields(AlignConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown AlignConfig fields: {unknown}")
    return AlignConfig(**d)


def batch_from_numpy(d: Mapping) -> Batch:
    """A :class:`Batch` from a dict of the fields of the JAX package's
    ``pipeline.Batch``; ``bands`` is a dict with lo, delta, chunk_size,
    band_width (``dataclasses.asdict`` of the JAX package's ``ChunkedBands``)."""
    d = dict(d)
    b = d.pop("bands")
    bands = ChunkedBands(
        lo=np.asarray(b["lo"], np.int32).copy(),
        delta=np.asarray(b["delta"], np.int32).copy(),
        chunk_size=int(b["chunk_size"]),
        band_width=int(b["band_width"]),
    )
    f32 = ("x", "mu", "sigma")
    i32 = ("t_len", "n_ref", "codes", "ids", "window_start", "window_len", "strand")
    kw = {k: np.asarray(d[k], np.float32).copy() for k in f32}
    kw.update({k: np.asarray(d[k], np.int32).copy() for k in i32})
    return Batch(bands=bands, read_ids=list(d["read_ids"]),
                 contigs=list(d["contigs"]), n_reads=int(d["n_reads"]), **kw)


def subst_tables_from_numpy(tab4, valid, contig_offsets: Mapping[str, int],
                            g_total: int, k: int, device="cuda") -> SubstTables:
    """The JAX package's ``SubstTables`` fields, as numpy, in the port's layout.

    ``tab4`` is its ``(3, k*4, rows_p // 128, 1, 128)`` stacked table; joining
    the last three axes gives the port's ``(3, k*4, rows_p)`` — the same
    numbers at the same column offsets.
    """
    tab4 = np.asarray(tab4, np.float32)
    if tab4.ndim != 5 or tab4.shape[0] != 3 or tab4.shape[1] != 4 * k:
        raise ValueError(f"tab4: expected (3, {4 * k}, rows_p/128, 1, 128), "
                         f"got {tab4.shape}")
    tab = np.ascontiguousarray(tab4.reshape(3, 4 * k, -1))
    valid = np.asarray(valid, bool)
    if valid.shape != (tab.shape[2],):
        raise ValueError(f"valid: expected ({tab.shape[2]},), got {valid.shape}")
    return SubstTables(
        tab=torch.from_numpy(tab.copy()).to(device),
        valid=torch.from_numpy(valid.copy()).to(device),
        contig_offsets=dict(contig_offsets), g_total=int(g_total), k=int(k))
