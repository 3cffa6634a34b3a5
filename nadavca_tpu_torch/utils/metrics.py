"""Structured run metrics: counters and gauges (reads/s, skipped reads,
padding waste), reported as one JSON line.

Copy of ``nadavca_tpu/utils/metrics.py`` (the ``write_jsonl`` sink, which no
entry point calls, is left out), with one registry for the process,
:data:`PROCESS`: code below the command line counts into it (the bytes
``pipeline.stage_batch`` and ``parallel.sharded.shard_batch`` hand to the
device, ``upload_bytes``, and of those the bytes copied without waiting,
from page-locked memory, ``upload_async_bytes``: ``utils.upload``; the
device bytes of the genome tables each ``ops.subst_tables.
build_subst_tables`` makes, ``subst_table_bytes``), and each CLI command
resets it at its start and reports it at its end. A counter
reads host values only.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Dict, Optional, TextIO


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.t0 = time.time()
        # the CLI counts from its main thread and its staging thread
        self._lock = threading.Lock()

    def count(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def reset(self) -> None:
        """Empty every counter and gauge and restart the clock."""
        with self._lock:
            self.counters = {}
            self.gauges = {}
            self.t0 = time.time()

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        return {
            "elapsed_s": round(time.time() - self.t0, 3),
            "counters": counters,
            "gauges": {k: round(v, 4) for k, v in self.gauges.items()},
        }

    def report(self, stream: Optional[TextIO] = None) -> None:
        stream = stream or sys.stderr
        print(f"[metrics] {json.dumps(self.snapshot())}", file=stream)


# the process's registry (module docstring)
PROCESS = Metrics()
