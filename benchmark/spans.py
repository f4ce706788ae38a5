"""The port's span records (isvins_tpu_torch.utils.perf) joined with the
traced slice's profiler events, for the span readers of benchmark/metrics.

A span is perf's record (id, name, frame, thread, start_ns, end_ns, parent)
on time.perf_counter_ns() and the thread's native id; an instant has its
start equal to its end. A host event is (start_ns, end_ns, name, thread) on
kineto's clock: the kept session's kernel-launch calls
(trace.LAUNCH_CALLS) and perf's clock anchors (perf.ANCHOR + the
perf_counter_ns stamp taken as the anchor opened, one per root span on the
frame thread).

What the join rests on, checked on the card (torch 2.11.0+cu128, NVIDIA
H100 80GB HBM3, 700 W, a probe of two threads launching kernels):
- The launch calls carry their thread in `device_resource_id()`; the
  events' `start_thread_id()` is 1 for all of them. That thread id is the
  native id (threading.get_native_id()) of a thread the session traces
  (the frame thread), and the low 32 bits of the pthread id
  (threading.get_ident()) of one it does not (the workers: a default session
  records no operation of a thread but the one that opened it), as a signed
  32-bit number (negative where bit 31 is set). perf keeps each recording
  thread's get_ident() (perf.threads()) to map them.
- Kineto's host times are Unix nanoseconds. The anchors give the offset,
  kineto start less stamp: the median over a session. Its quartiles lay
  7 us apart over 20 anchors of the probe and 36-139 us apart over the 8
  of a benchmark slice, 2 ms in one slice where the pose-graph worker held the
  interpreter between a stamp and its record; a process's first anchor
  opens ~0.2-0.3 ms late.
- An anchor encloses no kernel and puts no event on the device timeline
  (no device event of the 12 kept sessions of both cells checked was an
  annotation); a record_function that encloses kernels does (a
  `gpu_user_annotation`, which trace.summarize_events would count as busy
  time).

run_cell hands the readers the kept session's summary (ctx["trace"]) and
not its events, and no span records: `session_events` reads the events
from the live trace.Slice whose summary that is, and `window_spans` the
spans from the port's recorder, which the harness turns on for the window
only. A harness that puts them into ctx (ctx["spans"], ctx["span_threads"],
ctx["trace"]["host_events"], ctx["trace"]["device_intervals"]) is read
first. Every reader returns None where there is nothing to read.

A reader of the launches under a span of its own (a new kernel's, say)
calls launches_under with the span's name or prefix: the join and the
thread map are launch_layers'."""

from __future__ import annotations

import bisect
import gc
import statistics

import numpy as np

ANCHOR = "perf.anchor:"  # isvins_tpu_torch.utils.perf.ANCHOR
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")  # trace.LAUNCH_CALLS
FRAME = "sys.frame"
LAYERS = ("trk", "est", "worker", "unattributed")


# ---------------------------------------------------------------- the inputs

def _perf():
    try:
        from isvins_tpu_torch.utils import perf
    except ImportError:
        return None
    return perf


def window_spans(ctx):
    """The window's span records, or None where the program records none."""
    if ctx.get("spans") is not None:
        return list(ctx["spans"]) or None
    perf = _perf()
    read = getattr(perf, "spans", None)
    return (read() or None) if read is not None else None


def span_threads(ctx) -> dict:
    """{native thread id: threading.get_ident()} of the recording threads."""
    if ctx.get("span_threads") is not None:
        return dict(ctx["span_threads"])
    read = getattr(_perf(), "threads", None)
    return read() if read is not None else {}


def _live_slice(summary):
    """The trace.Slice whose kept summary is `summary` (None if gone)."""
    for o in gc.get_referrers(summary):
        owners = gc.get_referrers(o) if isinstance(o, dict) else [o]
        for c in owners:
            if getattr(c, "summary", None) is summary and isinstance(getattr(c, "done", None), list):
                return c
    return None


def events_of(prof):
    """(host events, device intervals) of one profiler session: its launch
    calls and anchors as (start_ns, end_ns, name, thread), and every
    device event as (start_ns, end_ns)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            dev.append((e.start_ns(), e.end_ns()))
            continue
        name = e.name()
        if name.startswith(LAUNCH_CALLS) or name.startswith(ANCHOR):
            host.append((e.start_ns(), e.end_ns(), name, e.device_resource_id()))
    return host, dev


def session_events(ctx):
    """(host events, device intervals) of the kept session, or None."""
    tr = ctx.get("trace")
    if not tr:
        return None
    if "host_events" in tr:
        return tr["host_events"], tr.get("device_intervals", [])
    sl = _live_slice(tr)
    if sl is None or not 1 <= tr.get("session", 0) <= len(sl.done):
        return None
    return events_of(sl.done[tr["session"] - 1][0])


# ---------------------------------------------------------------- the join

def clock_offset(host_events):
    """(offset_ns, spread_ns): kineto time less perf_counter time, the
    median over the anchors, and the distance between their quartiles
    (statistics.quantiles); None without an anchor."""
    d = sorted(a - int(name[len(ANCHOR):]) for a, _, name, _ in host_events
               if name.startswith(ANCHOR))
    if not d:
        return None
    med = statistics.median_low(d)
    q = statistics.quantiles([x - med for x in d], n=4) if len(d) > 1 else [0, 0, 0]
    return med, float(q[2] - q[0])


def thread_map(spans, threads: dict) -> dict:
    """{a profiler's thread id: native id}: each span thread's native id as
    itself, and the low 32 bits of each recording thread's get_ident(), read
    unsigned and as the signed 32-bit number the profiler may give."""
    m = {}
    for native, ident in threads.items():
        low = ident & 0xFFFFFFFF
        m[low] = m[low - (1 << 32) if low >= 1 << 31 else low] = native
    m.update({s.thread: s.thread for s in spans})
    return m


class Timeline:
    """The spans of each thread, for the innermost span open at a time."""

    def __init__(self, spans):
        self.by_id = {s.id: s for s in spans}
        self.threads = {}
        for s in sorted((s for s in spans if s.end_ns > s.start_ns), key=lambda s: s.start_ns):
            self.threads.setdefault(s.thread, []).append(s)
        self.starts = {t: [s.start_ns for s in v] for t, v in self.threads.items()}

    def innermost(self, thread, t):
        """The innermost span open on `thread` at `t`, or None. Spans of a
        thread nest, so it is the last one to start by `t` or one of that
        span's ancestors on the same thread."""
        starts = self.starts.get(thread)
        if not starts:
            return None
        i = bisect.bisect_right(starts, t) - 1
        s = self.threads[thread][i] if i >= 0 else None
        while s is not None and s.thread == thread:
            if s.end_ns >= t:
                return s
            s = self.by_id.get(s.parent) if s.parent is not None else None
        return None

    def root(self, s, same_thread: bool = False):
        """The span's outermost ancestor (on its own thread only, with
        `same_thread`)."""
        while s.parent is not None and s.parent in self.by_id:
            up = self.by_id[s.parent]
            if same_thread and up.thread != s.thread:
                break
            s = up
        return s


def frame_thread(spans):
    """The native id of the thread that records `sys.frame`, or None."""
    for s in spans:
        if s.name == FRAME:
            return s.thread
    return None


def union(intervals):
    """The disjoint union of (a, b) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(merged, a, b) -> int:
    """How much of [a, b] the disjoint sorted intervals `merged` cover."""
    return sum(max(0, min(b, y) - max(a, x)) for x, y in merged if x < b and y > a)


def self_time(span, children) -> int:
    """A span's duration less the union of its children's intervals."""
    return (span.end_ns - span.start_ns) - sum(
        b - a for a, b in union((max(c.start_ns, span.start_ns), min(c.end_ns, span.end_ns))
                                for c in children))


def excluded_roots(spans, ctx) -> set:
    """Ids of the `sys.frame` spans recorded while a profiler session ran:
    the i-th `sys.frame` record is the phase's i-th sample, and
    ctx["excluded"] holds the sample ranges of each session."""
    ranges = ctx.get("excluded", {}).get(FRAME, ())
    roots = [s for s in spans if s.name == FRAME]
    return {s.id for i, s in enumerate(roots) if any(a <= i < b for a, b in ranges)}


def launch_spans(host_events, spans, offset_ns: int, threads: dict):
    """(native thread id or None, innermost span or None) of each launch
    call: the span open on the call's own thread as it started (None on a
    thread no span was recorded on)."""
    tl, tmap = Timeline(spans), thread_map(spans, threads)
    for a, _, name, th in host_events:
        if not name.startswith(LAUNCH_CALLS):
            continue
        native = tmap.get(th)
        yield native, tl.innermost(native, a - offset_ns) if native is not None else None


def launch_layers(host_events, spans, offset_ns: int, threads: dict) -> dict:
    """Each launch call put down to a layer by the innermost span open on
    its own thread as it started: `trk` (a trk.* span), `est` (est.* on the
    frame thread), `worker` (any span on another thread; `pg` counts its
    pg.* part again), `unattributed` (no span, a sys.* span's self time, or
    a thread no span was recorded on). The first four sum to the launches."""
    ft = frame_thread(spans)
    n = dict.fromkeys(LAYERS + ("pg",), 0)
    for native, s in launch_spans(host_events, spans, offset_ns, threads):
        if s is None:
            n["unattributed"] += 1
        elif s.name.startswith("trk."):
            n["trk"] += 1
        elif native == ft and s.name.startswith("est."):
            n["est"] += 1
        elif native != ft:
            n["worker"] += 1
            n["pg"] += s.name.startswith("pg.")
        else:
            n["unattributed"] += 1
    return n


def idle_gaps(device_intervals, top: int = 10):
    """The `top` longest gaps (ns, start, end) between the union of the
    device intervals, longest first (trace.summarize_events' gaps)."""
    m = union(device_intervals)
    gaps = [(nxt[0] - cur[1], cur[1], nxt[0]) for cur, nxt in zip(m, m[1:])]
    return sorted(gaps, reverse=True)[:top]


def label_gaps(gaps, spans, offset_ns: int):
    """[gap_s, {a thread's root span name: its innermost span open at the
    gap's middle}] for each gap, over every host thread with one open."""
    tl = Timeline(spans)
    out = []
    for g, a, b in gaps:
        mid = (a + b) // 2 - offset_ns
        open_ = {}
        for th in tl.threads:
            s = tl.innermost(th, mid)
            if s is not None:
                open_[tl.root(s, same_thread=True).name] = s.name
        out.append([g / 1e9, open_])
    return out


# ------------------------------------------------------------- the readers

def _joined(ctx):
    """(spans, host events, device intervals, (offset, spread)) of a traced
    run, or None where either side is missing. Read once per run: kept in
    ctx, which every reader of the run shares."""
    if "_spans_joined" not in ctx:
        spans, ev = window_spans(ctx), session_events(ctx)
        off = clock_offset(ev[0]) if spans and ev is not None else None
        ctx["_spans_joined"] = None if off is None else (spans, ev[0], ev[1], off)
    return ctx["_spans_joined"]


def _joined_slice(ctx):
    """_joined(ctx), or None where it is None or the slice kept no frame."""
    j = _joined(ctx)
    return None if j is None or not ctx["trace"].get("frames") else j


def launches(ctx):
    """launch_layers over the kept slice, with the slice's frames, the
    clock offset and its spread (None where nothing is joined)."""
    j = _joined_slice(ctx)
    if j is None:
        return None
    spans, host, _, (off, spread) = j
    n = launch_layers(host, spans, off, span_threads(ctx))
    n.update(frames=ctx["trace"]["frames"], offset_ns=off, offset_spread_ns=spread)
    return n


def launches_per_frame(ctx, layer: str):
    n = launches(ctx)
    return None if n is None else n[layer] / n["frames"]


def launches_under(ctx, prefix: str):
    """The kept slice's launch calls on the frame thread whose innermost
    span (launch_spans) has a name that starts with `prefix`, over the
    slice's frames. None where nothing is joined."""
    j = _joined_slice(ctx)
    if j is None:
        return None
    spans, host, _, (off, _) = j
    ft = frame_thread(spans)
    n = sum(1 for native, s in launch_spans(host, spans, off, span_threads(ctx))
            if native == ft and s is not None and s.name.startswith(prefix))
    return n / ctx["trace"]["frames"]


def _kept_interval(spans, ctx):
    """(start, end) on perf's clock of the kept session's frames: the
    `sys.frame` spans of its sample range."""
    tr = ctx.get("trace") or {}
    ranges = ctx.get("excluded", {}).get(FRAME, ())
    k = tr.get("session", 0) - 1
    if not 0 <= k < len(ranges):
        return None
    a, b = ranges[k]
    roots = [s for s in spans if s.name == FRAME][a:b]
    return (roots[0].start_ns, roots[-1].end_ns) if roots else None


def pg_launches_per_keyframe(ctx):
    """The kept slice's launches inside pg.* spans on the worker over its
    keyframes: the `pg.push` spans that made one (they hold a child span),
    each counted by the share of it inside the slice."""
    n = launches(ctx)
    if n is None:
        return None
    spans = window_spans(ctx)
    iv = _kept_interval(spans, ctx)
    if iv is None:
        return None
    parents = {s.parent for s in spans if s.parent is not None}
    kf = sum(overlap([iv], s.start_ns, s.end_ns) / (s.end_ns - s.start_ns)
             for s in spans if s.name == "pg.push" and s.id in parents and s.end_ns > s.start_ns)
    return n["pg"] / kf if kf > 0 else None


def self_ms_p50(ctx):
    """The median over the window's frames (those of no profiler session)
    of `sys.frame` less the union of its children (ms)."""
    spans = window_spans(ctx)
    if not spans:
        return None
    skip = excluded_roots(spans, ctx)
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    vals = [self_time(r, [c for c in kids.get(r.id, ()) if c.thread == r.thread])
            for r in spans if r.name == FRAME and r.id not in skip]
    return float(np.median(vals)) / 1e6 if vals else None


def tail_busy_pct(ctx, name: str):
    """Over the frames whose in-program latency (from the start of their
    `sys.frame` to the end of the root span that records their
    `sys.pose_out`) is at or above its p90: the time inside `name` spans
    (their union) within those intervals over the intervals' total (%).
    Frames whose interval holds a root recorded under a profiler session
    are left out; None without such frames or without a `name` span."""
    spans = window_spans(ctx)
    if not spans:
        return None
    tl, excl = Timeline(spans), excluded_roots(spans, ctx)
    roots = {s.frame: s for s in spans if s.name == FRAME}
    skip = [(r.start_ns, r.end_ns) for r in roots.values() if r.id in excl]
    lat = []
    for e in spans:
        if e.name != "sys.pose_out" or e.frame not in roots:
            continue
        a, b = roots[e.frame].start_ns, tl.root(e).end_ns
        if b > a and not any(x < b and y > a for x, y in skip):
            lat.append((b - a, a, b))
    work = union((s.start_ns, s.end_ns) for s in spans if s.name == name)
    if not lat or not work:
        return None
    p90 = np.percentile([x for x, _, _ in lat], 90)
    tail = [(a, b) for x, a, b in lat if x >= p90]
    return 100.0 * sum(overlap(work, a, b) for a, b in tail) / sum(b - a for a, b in tail)


def idle_by_span(ctx, top: int = 10):
    """The `top` longest idle gaps of the kept slice, each labelled with
    the innermost span open at its middle on each host thread; None where
    nothing is joined."""
    j = _joined(ctx)
    if j is None:
        return None
    spans, _, dev, (off, _) = j
    return label_gaps(idle_gaps(dev, top), spans, off)
