"""pod5 ingest (gated): the successor format to fast5 (Apache Arrow based).

The ``pod5`` package is optional: environments that have it get full
ingest, others get a clear error. The returned records are the same RawRead
objects the fast5 path produces, so everything downstream is format-agnostic.
Copy of ``nadavca_tpu/io/pod5.py``.
"""

from __future__ import annotations

import os
from typing import Iterator, List

import numpy as np

from .fast5 import RawRead

try:
    import pod5 as _pod5

    HAVE_POD5 = True
except ImportError:
    _pod5 = None
    HAVE_POD5 = False


def read_pod5(path: str) -> List[RawRead]:
    """All reads of a .pod5 file (requires the ``pod5`` package)."""
    if not HAVE_POD5:
        raise RuntimeError(
            "pod5 support requires the 'pod5' package, which is not installed "
            "in this environment; convert to fast5 or install pod5."
        )
    out: List[RawRead] = []
    with _pod5.Reader(path) as reader:
        for rec in reader.reads():
            calib = rec.calibration
            signal_pa = (rec.signal.astype(np.float32) + calib.offset) * calib.scale
            out.append(
                RawRead(
                    read_id=str(rec.read_id),
                    signal_pa=signal_pa,
                    basecall=None,   # pod5 stores raw signal only
                    move_index=None,
                    sampling_rate=float(rec.run_info.sample_rate),
                )
            )
    return out


def iter_pod5_dir(directory: str, shard=None) -> Iterator[RawRead]:
    """Stream reads from every .pod5 under a directory; shard=(pid, n)
    round-robins files across processes (multi-host shared-nothing ingest)."""
    paths = []
    for root, _dirs, files in sorted(os.walk(directory)):
        for fn in sorted(files):
            if fn.endswith(".pod5"):
                paths.append(os.path.join(root, fn))
    if shard is not None:
        pid, n = shard
        paths = [p for i, p in enumerate(paths) if i % n == pid]
    for p in paths:
        yield from read_pod5(p)
