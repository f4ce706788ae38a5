"""Per-phase wall-clock accounting and span recording for the frame path.

One registry holds, while enabled, what each `phase` records:
- `_SAMPLES`: each phase name's durations in seconds, in the order they
  ended (the per-frame budget breakdown of `stats` and `report`);
- the span records of `spans()`: each phase's name, the frame it serves,
  its thread (`threading.get_native_id()`), its start and end on
  `time.perf_counter_ns()`, and its parent, the enclosing span on the same
  thread or the span handed in explicitly across threads; `event` adds
  instants (start equal to end).

A span names its frame when the caller gives one, else takes its parent's.
The registry is guarded by a lock: spans are recorded from the
marginalization and pose-graph worker threads as well as from the frame
thread. While disabled a phase costs one flag check and records nothing.

A root span (no parent) also emits a clock anchor while enabled: an empty
`torch.profiler.record_function` named `perf.anchor:<perf_counter_ns>`,
which encloses no kernel. A profiler session that records it ties its own
clock to the spans' (`ANCHOR` + the stamp; benchmark/spans.py joins them).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

ANCHOR = "perf.anchor:"

_ENABLED = False
_LOCK = threading.Lock()
_SAMPLES = defaultdict(list)  # name -> [dt_s, ...] (frame-path counts; tiny)
_SPANS = []  # Span records, in the order they ended
_THREADS = {}  # native id -> threading.get_ident() of each thread that recorded
_IDS = itertools.count(1)
_LOCAL = threading.local()  # .open: the thread's open spans, innermost last


class Span(NamedTuple):
    id: int
    name: str
    frame: Optional[int]
    thread: int  # threading.get_native_id()
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]  # the parent span's id


class _Open:
    """An open span: what `phase` yields and `current` returns, the handle
    a caller passes to another thread as its work's parent."""

    __slots__ = ("id", "name", "frame", "parent", "start_ns")

    def __init__(self, name, frame, parent):
        self.id, self.name, self.frame, self.parent = next(_IDS), name, frame, parent


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def reset():
    with _LOCK:
        _SAMPLES.clear()
        _SPANS.clear()


def _open_spans() -> list:
    try:
        return _LOCAL.open
    except AttributeError:
        _LOCAL.open = []
        _LOCAL.thread = threading.get_native_id()
        with _LOCK:
            _THREADS[_LOCAL.thread] = threading.get_ident()
        return _LOCAL.open


def _anchor():
    from torch.autograd.profiler import record_function

    with record_function(f"{ANCHOR}{time.perf_counter_ns()}"):
        pass


def _record(sp: _Open, end_ns: int, dt: Optional[float]):
    """Keep the span ending at `end_ns`, and `dt` among its name's samples
    (None: an instant, which has none)."""
    rec = Span(sp.id, sp.name, sp.frame, _LOCAL.thread, sp.start_ns, end_ns,
               None if sp.parent is None else sp.parent.id)
    with _LOCK:
        if dt is not None:
            _SAMPLES[sp.name].append(dt)
        _SPANS.append(rec)


def _new(name: str, frame, parent) -> _Open:
    stack = _open_spans()
    up = parent if parent is not None else (stack[-1] if stack else None)
    if frame is None and up is not None:
        frame = up.frame
    return _Open(name, frame, up)


@contextlib.contextmanager
def phase(name: str, frame: Optional[int] = None, parent: Optional[_Open] = None):
    """Time the block as phase `name`; yields its span handle (None while
    disabled). `frame`: the frame it serves (default: the parent's);
    `parent`: the span it was handed from another thread (default: the
    enclosing span on this thread)."""
    if not _ENABLED:
        yield None
        return
    sp = _new(name, frame, parent)
    if sp.parent is None:
        _anchor()
    stack = _LOCAL.open
    stack.append(sp)
    sp.start_ns = time.perf_counter_ns()
    try:
        yield sp
    finally:
        end = time.perf_counter_ns()
        stack.pop()
        _record(sp, end, (end - sp.start_ns) / 1e9)


def current() -> Optional[_Open]:
    """The innermost open span on the calling thread (None while disabled
    or outside every span): the parent to hand to another thread."""
    if not _ENABLED:
        return None
    stack = _open_spans()
    return stack[-1] if stack else None


def event(name: str, frame: Optional[int] = None):
    """Record an instant under the innermost open span (its frame unless
    `frame` is given)."""
    if _ENABLED:
        sp = _new(name, frame, None)
        sp.start_ns = time.perf_counter_ns()
        _record(sp, sp.start_ns, None)


def add(name: str, dt: float):
    """Record an externally-timed interval, ending now."""
    if _ENABLED:
        sp = _new(name, None, None)
        end = time.perf_counter_ns()
        sp.start_ns = end - round(dt * 1e9)
        _record(sp, end, dt)


def spans() -> list:
    """A copy of the span records so far (`Span` tuples, in the order
    they ended)."""
    with _LOCK:
        return list(_SPANS)


def threads() -> dict:
    """{native id: threading.get_ident()} of every thread that has recorded
    (a profiler names a thread it did not trace by the low 32 bits of its
    pthread id, which is get_ident())."""
    with _LOCK:
        return dict(_THREADS)


def thread_total_s(*names) -> float:
    """Seconds recorded so far under `names` by the calling thread alone
    (unrounded): a caller that reads it before and after a step gets the
    step's share of those phases, whatever other threads record meanwhile."""
    me = threading.get_native_id()
    with _LOCK:
        return sum(s.end_ns - s.start_ns for s in _SPANS
                   if s.thread == me and s.name in names) / 1e9


def stats() -> dict:
    """{name: {count, total_ms, mean_ms, median_ms, max_ms}} snapshot.
    The median is the steady-state cost (immune to the one-off build and
    warm-up spikes that dominate mean/max on a fresh process)."""
    import numpy as np

    with _LOCK:
        items = [(k, list(v)) for k, v in _SAMPLES.items()]
    out = {}
    for name, xs in items:
        a = np.asarray(xs)
        out[name] = {
            "count": int(a.size),
            "total_ms": round(float(a.sum()) * 1e3, 2),
            "mean_ms": round(float(a.mean()) * 1e3, 3),
            "median_ms": round(float(np.median(a)) * 1e3, 3),
            "max_ms": round(float(a.max()) * 1e3, 2),
        }
    return out


def report(n_frames: int = 0) -> str:
    """Human-readable table, sorted by total time; with n_frames the
    per-frame amortized cost is shown."""
    rows = sorted(stats().items(), key=lambda kv: -kv[1]["total_ms"])
    lines = []
    for name, s in rows:
        per_frame = (
            f" {s['total_ms'] / max(n_frames, 1):8.2f} ms/frame"
            if n_frames
            else ""
        )
        lines.append(
            f"{name:<28} n={s['count']:<5} total={s['total_ms']:9.1f} ms "
            f"med={s['median_ms']:8.3f} ms mean={s['mean_ms']:8.3f} ms "
            f"max={s['max_ms']:8.1f} ms{per_frame}"
        )
    return "\n".join(lines)
