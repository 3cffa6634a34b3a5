"""Genome-level substituted-level tables for the SNP rescore.

Counterpart of ``nadavca_tpu/ops/subst_tables.py``. The substituted k-mer
levels of the local rescore are a pure function of the GENOME: for genome
base position g, window slot j and candidate base b, the affected k-mer is
the one starting at g-k+1+j with its j-th-from-right digit replaced by b. So
they are computed once per genome (host numpy, vectorized):

    mu[g, j, b], sg[g, j, b]   for the forward strand, and the same for the
    reverse-complement coordinate system (rev-strand read windows are
    contiguous slices of revcomp(genome))

and a read's window is then one contiguous run of columns at offset wstart
(fwd) or 2G' - wend (rev) — no gathers at batch time.

Layout: the stacked ``[em, mu, iv]`` table is ONE contiguous
``(3, k*4, rows_p)`` float32 tensor. A thread of the rescore kernel reads
column ``woff[r] + i`` directly and neighbouring positions coalesce, so the
column axis is not split into blocks. The fills (``em`` NEG_INF, ``mu`` 0,
``iv`` 1), ``rows_p``, the N gap between contigs and the tail pad are those of
the JAX package, so a window offset is the same number in both.

Edge semantics: positions whose k-mer window leaves the genome (or touches an
N base) are marked invalid; read-local edge positions (clipped windows) are
masked by the caller, which loses the outer k-1 positions of each read — a
deliberate approximation (coverage there is dominated by interior positions
of overlapping reads).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..genome import Genome, kmer_ids, reverse_complement
from ..kmer_model import KmerModel
from ..utils.metrics import PROCESS as METRICS

NEG_INF = -1e30
_HALF_LOG_2PI = 0.5 * float(np.log(2.0 * np.pi))


def _strand_tables(codes: np.ndarray, model: KmerModel):
    """(G, k, 4) mu/sg + (G,) validity for one strand of one contig."""
    k = model.k
    G = len(codes)
    ids = kmer_ids(codes, k)                     # (G-k+1,)
    mu = np.zeros((G, k, 4), np.float32)
    sg = np.ones((G, k, 4), np.float32)
    valid = np.zeros(G, bool)
    if G < k:
        return mu, sg, valid
    interior = np.arange(k - 1, G - k + 1)       # positions with all k kmers
    base = codes[interior].astype(np.int64)      # (M,)
    ok = base <= 3
    for j in range(k):
        p = interior - (k - 1) + j               # kmer start for slot j
        idp = ids[p]
        okj = ok & (idp >= 0)
        for b in range(4):
            nid = idp + (b - base) * (4 ** j)
            nid = np.clip(nid, 0, 4 ** k - 1)
            mu[interior, j, b] = np.where(okj, model.level_mean[nid], 0.0)
            sg[interior, j, b] = np.where(okj, model.level_std[nid], 1.0)
        if j == 0:
            valid_j = okj.copy()
        valid_j &= okj
    valid[interior] = valid_j
    return mu, sg, valid


@dataclasses.dataclass
class SubstTables:
    """Device-resident substituted-level tables for one genome.

    ``level_mean`` / ``level_std``: the model's (4^k,) float32 level vectors
    on the same device, put there once with the tables, so that a batch
    staged on the tables path uploads none (the tables rescore does not read
    them; the ``scan`` twin and the no-tables kernel on the same staged
    batch do). None where the tables came from elsewhere."""

    tab: torch.Tensor      # (3, k*4, rows_p) f32, stacked [em, mu, iv]
    valid: torch.Tensor    # (rows_p,) bool
    contig_offsets: Dict[str, int]   # contig -> column offset of its fwd block
    g_total: int           # Gp (columns per strand block)
    k: int
    level_mean: Optional[torch.Tensor] = None
    level_std: Optional[torch.Tensor] = None

    def to(self, device) -> "SubstTables":
        """The same tables on ``device``."""
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(self, tab=move(self.tab), valid=move(self.valid),
                                   level_mean=move(self.level_mean),
                                   level_std=move(self.level_std))

    @property
    def rows_p(self) -> int:
        return int(self.tab.shape[2])

    def window_offsets(self, contig_names, wstart: np.ndarray,
                       wlen: np.ndarray, strand: np.ndarray,
                       padded_len: int = 0) -> np.ndarray:
        """Column offset of each read's window slice in the concatenated table.

        Pass ``padded_len`` (the batch's padded window length L) to validate
        that every slice stays inside the table: the rescore kernel reads
        ``padded_len`` columns from each offset with NO clamping, so a batch
        whose L exceeds the build-time tail pad would read out of bounds. On
        violation this raises with the pad to rebuild with. The margin of 256
        columns is the JAX package's, kept so both raise on the same batch.
        """
        # .get: all-padding batches carry "" rows
        base = np.asarray([self.contig_offsets.get(c, 0) for c in contig_names],
                          np.int64)
        fwd = base + wstart
        rev = self.g_total + (self.g_total - (base + wstart + wlen))
        off = np.where(strand > 0, fwd, rev).astype(np.int32)
        if padded_len and len(off):
            rows_p = self.rows_p
            worst = int(off.max()) + int(padded_len) + 256
            if worst > rows_p:
                raise ValueError(
                    f"padded window length {padded_len} overruns the subst "
                    f"table tail pad (needs {worst} rows, table has {rows_p}); "
                    f"rebuild with build_subst_tables(pad>="
                    f"{worst - rows_p + 8192})")
        return off


def build_subst_tables(genome: Genome, model: KmerModel, pad: int = 8192,
                       device="cuda") -> SubstTables:
    """Host-side build + upload to ``device`` (call once per genome), with
    the model's level vectors beside the tables. The device bytes of each
    build's table and validity are counted in
    ``utils.metrics.PROCESS`` as ``subst_table_bytes``: 3 * 4k floats and a
    validity byte a column, a column a base on each strand, so 578 bytes a
    genome base at k = 6 and 866 at k = 9."""
    k = model.k
    gap = 16  # N separators so k-mers never span contig boundaries
    offsets, off = {}, 0
    for contig in genome:
        offsets[contig.name] = off
        off += len(contig) + gap
    # tail padding so any (offset, L) slice stays in range
    Gp = off + pad
    concat = np.full(Gp, 4, np.int8)
    pos = 0
    for contig in genome:
        concat[pos:pos + len(contig)] = contig.codes
        pos += len(contig) + gap

    mu_f, sg_f, va_f = _strand_tables(concat, model)

    # reverse-complement block: tables over revcomp of the concatenated
    # genome; coordinate u = Gp-1-g, so rev windows are forward slices
    rc_codes = reverse_complement(concat)
    mu_r, sg_r, va_r = _strand_tables(rc_codes, model)

    # tail slack after the rc block: rev windows sit at the END of the rc
    # coordinate range, and a padded-L slice starting there must stay inside
    # the table (clamping would silently shift the whole slice)
    tail_mu = np.zeros((pad, k, 4), np.float32)
    tail_sg = np.ones((pad, k, 4), np.float32)
    tail_va = np.zeros(pad, bool)
    rows = 2 * Gp + pad
    k4 = k * 4
    mu = np.concatenate([mu_f, mu_r, tail_mu], axis=0).reshape(rows, k4)
    sg = np.concatenate([sg_f, sg_r, tail_sg], axis=0).reshape(rows, k4)
    valid = np.concatenate([va_f, va_r, tail_va], axis=0)
    # emission constants precomputed here so batches do no logs/divides
    em = (-np.log(sg) - _HALF_LOG_2PI).astype(np.float32)
    iv = (0.5 / (sg * sg)).astype(np.float32)
    # the JAX package's column count (a 128 multiple plus one spare block)
    rows_p = -(-rows // 128) * 128 + 128

    tab = np.empty((3, k4, rows_p), np.float32)
    for plane, (a, fill) in enumerate(((em, NEG_INF), (mu, 0.0), (iv, 1.0))):
        tab[plane, :, :rows] = a.T
        tab[plane, :, rows:] = fill
    valid_p = np.zeros(rows_p, bool)
    valid_p[:rows] = valid
    dev = torch.device(device)
    METRICS.count("subst_table_bytes", tab.nbytes + valid_p.nbytes)
    return SubstTables(
        tab=torch.from_numpy(tab).to(dev),
        valid=torch.from_numpy(valid_p).to(dev),
        contig_offsets=offsets, g_total=Gp, k=k,
        level_mean=torch.from_numpy(model.level_mean.astype(np.float32)).to(dev),
        level_std=torch.from_numpy(model.level_std.astype(np.float32)).to(dev),
    )
