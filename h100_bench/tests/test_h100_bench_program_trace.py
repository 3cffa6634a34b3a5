"""``program_trace``: the program's spans of a traced window, the attribution
of each device operation to the spans its launch was in, the idle time by
program span, and the arithmetic of the readers built on them, on synthetic
traces (the CPU has no device activity to attribute)."""

import pytest

from h100_bench import program_trace as pt
from h100_bench import trace as tracemod

MS = 1_000_000

# one batch of a window from 0 to 100 ms on thread 1: the upload (with its
# offsets), then the step with the fill, the scatter and the two sums
SPANS = [("nadavca.upload", 0, 20 * MS), ("nadavca.upload.offsets", 1 * MS, 3 * MS),
         ("nadavca.step", 20 * MS, 60 * MS), ("nadavca.fill", 21 * MS, 30 * MS),
         ("nadavca.merge", 31 * MS, 32 * MS), ("nadavca.accumulate", 33 * MS, 40 * MS),
         ("nadavca.merge", 41 * MS, 45 * MS)]


class Event:
    """What ``from_profile`` reads of a profiler event."""

    def __init__(self, name, start, dur, device="CPU", corr=0, tid=1, ua=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c, self._t, self._ua = device, corr, tid, ua

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType." + self._dev

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._ua or self._n.startswith(("nadavca.", "bench."))


class Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()


def _launch(name, t_host, start, dur, corr, tid=1):
    return [Event("cudaLaunchKernel" if "Memcpy" not in name else "cudaMemcpyAsync",
                  t_host, 5_000, corr=corr, tid=tid),
            Event(name, start, dur, device="CUDA", corr=corr)]


def _profile():
    ev = [Event("bench.window", 0, 100 * MS), Event("bench.window", 0, 100 * MS,
                                                    device="CUDA", ua=True)]
    ev += [Event(n, a, b - a) for n, a, b in SPANS]
    # a span's mirror on the device's timeline is no device activity
    ev += [Event("nadavca.step", 22 * MS, 30 * MS, device="CUDA", ua=True)]
    # a frontend op whose id is one of the runtime's: never taken for a launch
    ev += [Event("aten::index_add_", 34 * MS, 1 * MS, corr=4)]
    ev += _launch("Memcpy HtoD (Pageable -> Device)", 2 * MS, 2 * MS, 10 * MS, 1)
    ev += _launch("Memcpy HtoD (Pageable -> Device)", 15 * MS, 12 * MS, 6 * MS, 2)
    ev += _launch("viterbi_fill_kernel<4, true>", 22 * MS, 22 * MS, 20 * MS, 3)
    ev += _launch("Memset (Device)", 31 * MS + 10, 42 * MS, 1 * MS, 4)
    ev += _launch("indexFuncLargeIndex", 35 * MS, 43 * MS, 3 * MS, 5)
    ev += _launch("Memcpy DtoD (Device -> Device)", 42 * MS, 46 * MS, 4 * MS, 6)
    # outside every program span; and on another thread inside the window
    ev += _launch("reduce_kernel", 61 * MS, 62 * MS, 1 * MS, 7)
    ev += _launch("other_thread_kernel", 36 * MS, 70 * MS, 2 * MS, 8, tid=2)
    # before the window: clipped away
    ev += _launch("early_kernel", -5 * MS, -4 * MS, 1 * MS, 9)
    return Profile(ev)


@pytest.fixture()
def traced():
    prof = _profile()
    tr = tracemod.from_profile(prof)
    return tr, pt.from_profile(prof, tr)


def test_pieces_name_the_innermost_open_span():
    st = pt.stacks_at(SPANS, [0, 2 * MS, 20 * MS, 25 * MS, 30 * MS + 1, 31 * MS, 44 * MS,
                              59 * MS, 60 * MS, None])
    assert st == [("nadavca.upload",), ("nadavca.upload", "nadavca.upload.offsets"),
                  ("nadavca.step",), ("nadavca.step", "nadavca.fill"), ("nadavca.step",),
                  ("nadavca.step", "nadavca.merge"), ("nadavca.step", "nadavca.merge"),
                  ("nadavca.step",), (), ()]
    ps = pt.pieces(SPANS)
    assert all(a < b for a, b, _ in ps)
    assert all(p[1] <= q[0] for p, q in zip(ps, ps[1:]))
    assert sum(b - a for a, b, _ in ps) == 60 * MS
    # a child that outlasts its parent is cut at the parent's end
    assert pt.pieces([("p", 0, 10), ("c", 5, 20)]) == [(0, 5, ("p",)), (5, 10, ("p", "c"))]


def test_each_launch_goes_to_the_spans_of_its_runtime_call(traced):
    tr, prog = traced
    got = {n: s for (n, _, _), s in zip(tr.device, prog.launched_in)}
    assert "early_kernel" not in got
    assert got["viterbi_fill_kernel<4, true>"] == ("nadavca.step", "nadavca.fill")
    assert got["Memset (Device)"] == ("nadavca.step", "nadavca.merge")
    assert got["indexFuncLargeIndex"] == ("nadavca.step", "nadavca.accumulate")
    assert got["Memcpy DtoD (Device -> Device)"] == ("nadavca.step", "nadavca.merge")
    assert got["reduce_kernel"] == () and got["other_thread_kernel"] == ()
    h2d = [s for (n, _, _), s in zip(tr.device, prog.launched_in) if "HtoD" in n]
    assert h2d == [("nadavca.upload", "nadavca.upload.offsets"), ("nadavca.upload",)]
    assert [n for n, _, _ in prog.spans] == [n for n, _, _ in SPANS]


def test_the_readers_arithmetic(traced):
    tr, prog = traced
    # accumulate: the index_add_ kernel, 3 ms; merge: the memset and the copy, 5 ms
    assert pt.ms_per_batch(tr, prog, "nadavca.accumulate", 1) == pytest.approx(3.0)
    assert pt.ms_per_batch(tr, prog, "nadavca.merge", 2) == pytest.approx(2.5)
    # 16 ms of HtoD inside the upload, 0.32 GB moved
    assert pt.h2d_gb_per_s(tr, prog, 0.32e9) == pytest.approx(20.0)
    # fill, memset, index_add_, copy inside the step
    assert pt.launches_per_batch(tr, prog, 2) == 2.0
    # nothing inside: None, as from a program without these spans
    assert pt.ms_per_batch(tr, prog, "nadavca.walk", 1) is None
    bare = pt.Program([], [()] * len(tr.device))
    assert pt.h2d_gb_per_s(tr, bare, 1e9) is None
    assert pt.launches_per_batch(tr, bare, 1) is None
    assert pt.ms_per_batch(tr, bare, "nadavca.accumulate", 1) is None


def test_attributed_and_the_rest_make_the_whole(traced):
    tr, prog = traced
    split = pt.device_ns_by_name(tr, prog)
    total = tr.by_name()
    assert set(split) == set(total)
    for n, (inside, rest) in split.items():
        assert abs((inside + rest) * 1e-9 - total[n]) < 1e-9, n
    assert split["reduce_kernel"] == (0, MS) and split["indexFuncLargeIndex"] == (3 * MS, 0)


def test_idle_gaps_program_sum_to_the_idle_gaps(traced):
    tr, prog = traced
    prog_gaps = pt.idle_gaps_program(tr, prog)
    assert sum(prog_gaps.values()) == pytest.approx(sum(tr.idle_by_span().values()),
                                                    rel=1e-12)
    assert sum(prog_gaps.values()) == pytest.approx(tr.window_s - tr.busy_s, rel=1e-12)
    # busy 2-18, 22-50, 62-63, 70-72 ms; idle 0-2 (upload 0-1, its offsets
    # 1-2), 18-22 (upload 18-20, step 20-21, fill 21-22), 50-62 (step 50-60,
    # outside 60-62), 63-70 and 72-100 outside
    assert prog_gaps == pytest.approx({"upload": 0.003, "upload.offsets": 0.001,
                                       "step": 0.011, "fill": 0.001, "outside": 0.037})
    rows = pt.breakdown_program(tr, prog)
    assert [n for n, _ in rows][:3] == ["outside", "step", "upload"] and len(rows) == 5


def test_a_cpu_profile_keeps_the_window_threads_spans():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with record_function("nadavca.step"):
                torch.ones(4).sum()
    tr = tracemod.from_profile(prof)
    prog = pt.from_profile(prof, tr)
    assert [n for n, _, _ in prog.spans] == ["nadavca.step"]
    assert prog.launched_in == [] and tr.device == []
    assert pt.idle_gaps_program(tr, prog).keys() <= {"step", "outside"}
