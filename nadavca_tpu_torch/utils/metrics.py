"""Structured run metrics: counters and gauges (reads/s, skipped reads,
padding waste), reported as one JSON line.

Copy of ``nadavca_tpu/utils/metrics.py`` (the ``write_jsonl`` sink, which no
entry point calls, is left out).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional, TextIO


class Metrics:
    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.t0 = time.time()

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def snapshot(self) -> dict:
        return {
            "elapsed_s": round(time.time() - self.t0, 3),
            "counters": dict(self.counters),
            "gauges": {k: round(v, 4) for k, v in self.gauges.items()},
        }

    def report(self, stream: Optional[TextIO] = None) -> None:
        stream = stream or sys.stderr
        print(f"[metrics] {json.dumps(self.snapshot())}", file=stream)
