"""Sidecar basecall sources joined to raw-signal-only reads by read_id.

pod5 stores raw signal ONLY — unlike fast5 there is no embedded basecall
group, so a pod5 read can never produce an alignment by itself (every
preprocessor drops reads without a basecall + move table). The basecalls
live in the basecaller's output instead; this module loads them and the CLI
(``--basecalls``) joins them onto ingested reads. Copy of
``nadavca_tpu/io/sidecar.py``.

Two formats:

* **TSV** (``.tsv``/``.txt``): ``read_id<TAB>basecall<TAB>move_csv`` where
  move_csv is the comma-separated signal sample index at which each base
  starts (len == len(basecall)). Lines starting with ``#`` are ignored.
* **SAM text** (``.sam``): the real basecaller convention — ``QNAME`` is the
  read id, ``SEQ`` the basecall, and the move table comes from the
  ``mv:B:c,<stride>,<m0>,<m1>,...`` tag (one flag per signal stride, 1 =
  a new base starts here) offset by the ``ts:i:<n>`` trim tag when present.
  Unmapped records are fine (this is a basecall source, not an alignment).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Sidecar = Dict[str, Tuple[str, np.ndarray]]


def _parse_tsv(path: str) -> Sidecar:
    out: Sidecar = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\r\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                raise ValueError(
                    f"{path}:{ln}: expected read_id<TAB>basecall<TAB>move_csv")
            rid, bc, mv = parts[0], parts[1], parts[2]
            moves = np.asarray([int(v) for v in mv.split(",") if v != ""],
                               np.int64)
            if len(moves) != len(bc):
                raise ValueError(
                    f"{path}:{ln}: {len(moves)} move entries for "
                    f"{len(bc)}-base call")
            out[rid] = (bc, moves)
    return out


_RC = str.maketrans("ACGTacgt", "TGCAtgca")


def _parse_sam(path: str) -> Sidecar:
    out: Sidecar = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            if not line.strip() or line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                raise ValueError(f"{path}:{ln}: not a SAM record")
            rid, seq = fields[0], fields[9]
            try:
                flag = int(fields[1])
            except ValueError:
                raise ValueError(f"{path}:{ln}: bad FLAG field {fields[1]!r}")
            if flag & 0x900:
                # secondary/supplementary: usually hard-clipped partial SEQ,
                # and must never overwrite the primary record's entry
                continue
            if seq in ("*", ""):
                continue
            if flag & 0x10:
                # reverse-strand mapping: SEQ is the reverse complement of
                # the basecall, but the mv tag stays in signal orientation —
                # restore read/signal orientation so the pair lines up
                seq = seq.translate(_RC)[::-1]
            stride = None
            flags = None
            ts = 0
            for tag in fields[11:]:
                if tag.startswith("mv:B:c,"):
                    vals = tag[len("mv:B:c,"):].split(",")
                    stride = int(vals[0])
                    flags = np.asarray([int(v) for v in vals[1:]], np.int8)
                elif tag.startswith("ts:i:"):
                    ts = int(tag[len("ts:i:"):])
            if flags is None:
                continue  # no move table -> unusable for signal anchoring
            starts = ts + stride * np.flatnonzero(flags == 1)
            if len(starts) != len(seq):
                # hard-clipped or otherwise truncated SEQ: the move table
                # covers the full read, so the pair cannot be joined — skip
                # the record rather than aborting the whole sidecar load
                continue
            out[rid] = (seq, starts.astype(np.int64))
    return out


def load_sidecar_basecalls(path: str) -> Sidecar:
    """read_id -> (basecall, move_index) from a TSV or SAM sidecar file."""
    if path.endswith(".sam"):
        return _parse_sam(path)
    return _parse_tsv(path)


def join_basecalls(raws, sidecar: Sidecar):
    """Yield reads with missing basecalls filled in from the sidecar.

    Reads that already carry a basecall (fast5 with an embedded Basecall
    group) pass through untouched; signal-only reads found in the sidecar
    get (basecall, move_index) attached; the rest pass through unchanged
    and are counted/skipped downstream like any basecall-less read.
    """
    import dataclasses

    for raw in raws:
        if raw.basecall is None and raw.read_id in sidecar:
            bc, mv = sidecar[raw.read_id]
            raw = dataclasses.replace(raw, basecall=bc,
                                      move_index=np.asarray(mv, np.int64))
        yield raw
