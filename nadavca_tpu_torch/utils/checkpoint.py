"""Checkpoint/resume of SNP accumulator state.

The reference has no checkpointing (batch tool, rerun from scratch). The
rebuild periodically persists (processed-read manifest, per-contig locus
accumulators) so a preempted long run resumes from the last merge: reload the
accumulators, skip reads already in the manifest. Plain npz + a text manifest;
writes are atomic (tmp + rename) so a crash mid-write never corrupts the
checkpoint.

Copy of ``nadavca_tpu/utils/checkpoint.py``: the same ``.npz`` layout and
manifest, so a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Iterable, Set, Tuple

import numpy as np


def save_checkpoint(
    path: str,
    accs: Dict[str, Tuple[np.ndarray, np.ndarray]],
    processed_read_ids: Iterable[str],
    meta: Dict[str, int] = None,
    read_metas=None,
) -> None:
    """Atomically persist accumulators + manifest to ``path`` (.npz).

    ``meta`` (int-valued) rides along under ``_meta``; the multi-host
    protocol stores the batch counter there to validate that the per-process
    manifest files and process 0's accumulator file describe the same point
    of the run (load_checkpoint returns it).

    ``read_metas`` is an optional flat sequence of
    :class:`nadavca_tpu_torch.joint.ReadMeta` — per-read placement rows persisted
    so a RESUMED run's joint-rescore pass can still locate the reads merged
    before the checkpoint (they are skipped by the manifest, so the batch
    loop never sees them again).
    """
    payload = {}
    names = sorted(accs)
    payload["_contigs"] = np.asarray(json.dumps(names))
    payload["_meta"] = np.asarray(json.dumps(meta or {}))
    if read_metas:
        payload["_rm_id"] = np.asarray([m.read_id for m in read_metas])
        payload["_rm_contig"] = np.asarray([m.contig for m in read_metas])
        payload["_rm_w"] = np.asarray(
            [(m.wstart, m.wlen, m.strand) for m in read_metas], np.int64)
    for name in names:
        arrs = accs[name]  # (acc, cov[, votes])
        payload[f"acc_{name}"] = np.asarray(arrs[0])
        payload[f"cov_{name}"] = np.asarray(arrs[1])
        if len(arrs) > 2:
            payload[f"votes_{name}"] = np.asarray(arrs[2])
    payload["_manifest"] = np.asarray(sorted(set(processed_read_ids)))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        # np.savez appends .npz to names without it
        tmp_written = tmp if tmp.endswith(".npz") else tmp + ".npz"
        os.replace(tmp_written, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, with_meta: bool = False):
    """Returns (accs dict, processed_read_ids set[, meta dict, read_metas]);
    empty if file is absent. ``read_metas`` is a list of
    nadavca_tpu_torch.joint.ReadMeta persisted by :func:`save_checkpoint`."""
    if not os.path.exists(path):
        return ({}, set(), {}, []) if with_meta else ({}, set())
    read_metas = []
    with np.load(path, allow_pickle=False) as z:
        names = json.loads(str(z["_contigs"]))
        meta = json.loads(str(z["_meta"])) if "_meta" in z else {}
        accs = {}
        for n in names:
            arrs = [z[f"acc_{n}"].copy(), z[f"cov_{n}"].copy()]
            if f"votes_{n}" in z:
                arrs.append(z[f"votes_{n}"].copy())
            accs[n] = tuple(arrs)
        manifest: Set[str] = set(str(x) for x in z["_manifest"])
        if with_meta and "_rm_id" in z:
            from ..joint import ReadMeta

            for rid, cname, (w0, wl, st) in zip(
                    z["_rm_id"], z["_rm_contig"], z["_rm_w"]):
                read_metas.append(ReadMeta(str(rid), str(cname),
                                           int(w0), int(wl), int(st)))
    if with_meta:
        return accs, manifest, meta, read_metas
    return accs, manifest
