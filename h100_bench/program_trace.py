"""The program's own spans in a traced window, and the device time they
launched.

``nadavca_tpu_torch`` marks its work with ``torch.profiler.record_function``
ranges named ``nadavca.*`` (``utils/profiling.span``): the upload, the step,
and inside the step the fill, the final slot, the walk, the rescore, the
scatter (``nadavca.accumulate``) and the genome-sized sums
(``nadavca.merge``). :func:`from_profile` keeps those spans on the thread
that ran the window (the thread of ``bench.window``) and puts each device
operation of :class:`trace.Trace` down to the spans that were open when the
host launched it: a kernel, copy or memset shares the profiler's correlation
id with the runtime call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``, ...), and that call's host time
lies inside the spans. An idle gap of the device is named by the innermost
program span the window's thread was in (:func:`idle_gaps_program`).

The readers below return None where nothing was launched inside their span,
as a program without these spans (or a trace without a device) gives.
``trace.from_profile`` and ``cell.Ctx`` do not carry what they read yet
(``PERF.md`` §7); ``scripts/torch_span_metrics.py`` runs a cell and reads
them."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace as tracemod

PREFIX = "nadavca."
OUTSIDE = "outside"
# the CUDA API calls that launch device work (cudaLaunchKernel, cuLaunchKernel, ...)
RUNTIME_PREFIX = "cu"

Stack = Tuple[str, ...]


@dataclasses.dataclass
class Program:
    """The program's spans of a traced window."""

    spans: List[Tuple[str, int, int]]     # (name, start, end) ns, the window's thread
    launched_in: List[Stack]              # per op of Trace.device: the spans open
                                          # at its launch, outermost first


def pieces(spans: Sequence[Tuple[str, int, int]]) -> List[Tuple[int, int, Stack]]:
    """Disjoint (start, end, stack) pieces of the time the spans cover, each
    with the spans open there, outermost first. The spans of one thread
    nest; one that outlasts its parent is cut at the parent's end."""
    out: List[Tuple[int, int, Stack]] = []
    stack: List[Tuple[str, int]] = []
    t = 0

    def close_until(x):
        nonlocal t
        while stack and stack[-1][1] <= x:
            end = stack[-1][1]
            if end > t:
                out.append((t, end, tuple(n for n, _ in stack)))
                t = end
            stack.pop()

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        close_until(a)
        if stack and a > t:
            out.append((t, a, tuple(n for n, _ in stack)))
        t = a
        stack.append((name, min(b, stack[-1][1]) if stack else b))
    close_until(float("inf"))
    return out


def stacks_at(spans, times: Sequence[Optional[int]]) -> List[Stack]:
    """The spans open at each host time (``()`` outside them, or for None)."""
    ps = pieces(spans)
    starts = [p[0] for p in ps]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        out.append(ps[i][2] if i >= 0 and t < ps[i][1] else ())
    return out


def from_profile(prof, tr: tracemod.Trace) -> Program:
    """The program's spans of ``prof`` (a finished ``torch.profiler.profile``)
    on the window's thread, and the spans each device operation of ``tr``
    (``trace.from_profile`` of the same profile) was launched in."""
    events = prof.profiler.kineto_results.events()
    w0, w1 = tr.window
    window_tid, host, runtime, device = None, [], {}, []
    for e in events:
        name = e.name()
        on_device = str(e.device_type()).endswith("CUDA")
        if name.startswith(tracemod.SPAN_PREFIX):
            if name == tracemod.WINDOW and not on_device:
                window_tid = e.start_thread_id()
        elif on_device:
            if not e.is_user_annotation():
                device.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.correlation_id()))
        elif name.startswith(PREFIX):
            host.append((e.start_thread_id(), name, e.start_ns(),
                         e.start_ns() + e.duration_ns()))
        elif name.startswith(RUNTIME_PREFIX):
            runtime[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    # the device operations of the window, in the order and with the clipping
    # of trace.from_profile
    ops = [(n, max(a, w0), min(b, w1), c) for n, a, b, c in device if b > w0 and a < w1]
    if [o[:3] for o in ops] != tr.device:
        raise RuntimeError("the profile's device operations are not the trace's")
    spans = [(n, a, b) for tid, n, a, b in host if tid == window_tid]
    launch = [runtime.get(c) for *_, c in ops]
    stacks = stacks_at(spans, [l[1] if l and l[0] == window_tid else None
                               for l in launch])
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in spans if b > w0 and a < w1]
    return Program(inside, stacks)


def idle_gaps_program(tr: tracemod.Trace, prog: Program) -> Dict[str, float]:
    """Idle seconds of the device within the window, by the innermost program
    span the window's thread was in (``outside`` where none was). Their sum
    is that of ``Trace.idle_by_span``."""
    gaps, t = [], tr.window[0]
    for a, b in tr.busy():
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < tr.window[1]:
        gaps.append((t, tr.window[1]))
    ps = pieces(prog.spans)
    out_ns: Dict[str, int] = {}
    first = 0
    for ga, gb in gaps:
        while first < len(ps) and ps[first][1] <= ga:
            first += 1
        covered = 0
        for a, b, stack in ps[first:]:
            if a >= gb:
                break
            ov = min(b, gb) - max(a, ga)
            if ov > 0:
                key = stack[-1][len(PREFIX):]
                out_ns[key] = out_ns.get(key, 0) + ov
                covered += ov
        if gb - ga > covered:
            out_ns[OUTSIDE] = out_ns.get(OUTSIDE, 0) + (gb - ga - covered)
    return {k: v * 1e-9 for k, v in out_ns.items()}


def breakdown_program(tr: tracemod.Trace, prog: Program, top: int = 10) -> list:
    """``idle_gaps_program`` as [name, seconds], largest first, at most ``top``."""
    idle = sorted(idle_gaps_program(tr, prog).items(), key=lambda kv: -kv[1])
    return [[n, s] for n, s in idle[:top]]


def device_ns_by_name(tr: tracemod.Trace, prog: Program) -> Dict[str, Tuple[int, int]]:
    """{operation name: (ns launched inside a program span, ns not)}."""
    out: Dict[str, Tuple[int, int]] = {}
    for (n, a, b), stack in zip(tr.device, prog.launched_in, strict=True):
        i, o = out.get(n, (0, 0))
        out[n] = (i + (b - a), o) if stack else (i, o + (b - a))
    return out


def device_s_inside(tr, prog, span: str, match=lambda n: True) -> float:
    """Seconds of the device operations launched inside ``span`` whose name
    ``match`` accepts."""
    return sum(b - a for (n, a, b), stack in zip(tr.device, prog.launched_in, strict=True)
               if span in stack and match(n)) * 1e-9


def ops_inside(tr, prog, span: str) -> int:
    """Device operations (kernels, copies, memsets) launched inside ``span``."""
    return sum(span in stack for stack in prog.launched_in)


def ms_per_batch(tr, prog, span: str, n_batches: int) -> Optional[float]:
    """Device milliseconds a batch of the operations launched inside ``span``
    (``accumulate_ms_per_batch``: ``nadavca.accumulate``;
    ``merge_ms_per_batch``: ``nadavca.merge``)."""
    s = device_s_inside(tr, prog, span)
    return s * 1e3 / n_batches if s > 0 and n_batches else None


def h2d_gb_per_s(tr, prog, upload_bytes: float) -> Optional[float]:
    """The window's ``upload_bytes`` over the device time of the host-to-device
    copies launched inside ``nadavca.upload``, in GB/s."""
    s = device_s_inside(tr, prog, PREFIX + "upload", lambda n: "HtoD" in n)
    return upload_bytes / s * 1e-9 if s > 0 and upload_bytes else None


def launches_per_batch(tr, prog, n_batches: int) -> Optional[float]:
    """Device operations launched inside ``nadavca.step``, a batch."""
    n = ops_inside(tr, prog, PREFIX + "step")
    return n / n_batches if n and n_batches else None
