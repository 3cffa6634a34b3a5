"""The traced window, reduced: device intervals by name, busy and idle time,
and the host's spans.

The harness marks its own spans with ``torch.profiler.record_function``
(names starting ``bench.``): the window, and inside it each batch's upload,
step call and drain. The profiler's device activity (kernels, copies,
memsets) is clipped to the window; an idle gap of the device is named by the
host span it overlaps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench."
WINDOW = "bench.window"


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]                      # ns
    device: List[Tuple[str, int, int]]           # (name, start, end) ns, clipped
    spans: List[Tuple[str, int, int]]            # harness spans inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy(self) -> List[Tuple[int, int]]:
        return _union([(a, b) for _, a, b in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def device_s(self, match) -> float:
        """Seconds of device activity whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.device if match(n)) * 1e-9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.device:
            out[n] = out.get(n, 0.0) + (b - a) * 1e-9
        return out

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the device within the window, by the innermost
        harness span the host was in (``loop`` outside every span)."""
        gaps, t = [], self.window[0]
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.window[1]:
            gaps.append((t, self.window[1]))
        # the harness's spans follow one another: one sweep over both lists
        spans = sorted((a, b, n) for n, a, b in self.spans if n != WINDOW)
        out: Dict[str, float] = {}
        first = 0
        for ga, gb in gaps:
            while first < len(spans) and spans[first][1] <= ga:
                first += 1
            covered = 0
            for a, b, n in spans[first:]:
                if a >= gb:
                    break
                ov = min(b, gb) - max(a, ga)
                if ov > 0:
                    key = n[len(SPAN_PREFIX):]
                    out[key] = out.get(key, 0.0) + ov * 1e-9
                    covered += ov
            rest = (gb - ga) - covered
            if rest > 0:
                out["loop"] = out.get("loop", 0.0) + rest * 1e-9
        return out


def from_profile(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Trace`."""
    events = prof.profiler.kineto_results.events()
    spans, device = [], []
    for e in events:
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            # the host's span; the profiler mirrors it on the device's
            # timeline as an annotation, which is no device activity
            if not str(e.device_type()).endswith("CUDA"):
                spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif str(e.device_type()).endswith("CUDA") and not e.is_user_annotation():
            device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    wins = [(a, b) for n, a, b in spans if n == WINDOW]
    if len(wins) != 1:
        raise RuntimeError(f"expected one {WINDOW} span in the trace, found {len(wins)}")
    w0, w1 = wins[0]
    clipped = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
    inside = [(n, a, b) for n, a, b in spans if b > w0 and a < w1]
    return Trace((w0, w1), clipped, inside)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, each as [name, seconds], at most ``top`` each."""
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(tr.idle_by_span().items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
