"""Spans and counters at the port's layer boundaries.

Tracing is on in two cases only:

* while a ``torch.profiler`` session records: the profiler's own enabled
  flag is read once at each outermost call span (:func:`call`: a training
  chunk or step, a ``predict_in_batches`` call, a serving cache build)
  and holds for every span inside it;
* inside a :func:`recording` block, for counters without a profiler.

Off, a span or counter site costs one test of the module flag :data:`ON`
(a call span adds the profiler's flag): no ``record_function``, no NVTX
range, no CUDA event and no record.

On, a span is

* a ``torch.profiler.record_function`` range while the profiler records
  (a ``user_annotation`` in the Chrome trace, on the profiler's clock
  beside the kernels);
* an NVTX range while CUDA is in use;
* a :class:`Span` record: its name, host start and end, its parent span,
  the id of its outermost call (the spans of one call share it) and a few
  attributes.  A span given a CUDA ``device`` also records a CUDA event
  on the current stream at entry and at exit; ``elapsed_time`` is read
  only by :meth:`Recording.summary`, after the caller's synchronize.

A span that a thread with no open span of its own opens inside a call
(the autograd engine's device thread runs the backward solves on CUDA)
takes as its parent the innermost open span of the thread that opened
the call.

Counters: :func:`host_read` counts every read of a device value on the
host by the function that reads; each ``cggp.cg.solve`` span keeps its
solve's ``(rows, m, steps)``, ``steps`` as the device tensor until the
summary, and the kernel B2 solve inside it its launch ``path``
(:func:`solve_path`).

The records of one stretch of traced calls form one :class:`Recording`:
a new one starts with a :func:`recording` block, or at the first traced
call after an untraced one.  :func:`latest` returns the newest.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
from collections import Counter
from typing import Callable, Dict, List, Optional

import torch

# Whether tracing is on: read by every span and counter site.
ON = False

SOLVE = "cggp.cg.solve"
_GRAD = "cggp.objective.grad"
_PREFIX = "cggp_tpu_torch."


def _profiler_enabled() -> bool:
    return torch._C._autograd._profiler_enabled()


class Span:
    """One span's record; ``start`` and ``end`` are ``time.perf_counter()``
    seconds."""

    __slots__ = ("name", "parent", "call", "attrs", "start", "end", "events")

    def __init__(self, name: str, parent: Optional["Span"], call: int, attrs: Dict):
        self.name, self.parent, self.call, self.attrs = name, parent, call, attrs
        self.start = self.end = 0.0
        self.events = None  # (start, end) CUDA events on a CUDA device

    def ancestors(self):
        node = self.parent
        while node is not None:
            yield node
            node = node.parent

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's CUDA events, None without them."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _covered(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


class Recording:
    """The spans and counters of one stretch of traced calls."""

    def __init__(self):
        self.spans: List[Span] = []
        self.host_reads: Counter = Counter()
        self.calls = 0

    def self_seconds(self) -> Dict[int, float]:
        """Each closed span's duration less the time its child spans cover,
        by ``id`` of the span."""
        children: Dict[int, list] = {}
        for span in self.spans:
            if span.parent is not None:
                children.setdefault(id(span.parent), []).append((span.start, span.end))
        return {id(s): (s.end - s.start) - _covered(
                    (max(a, s.start), min(b, s.end)) for a, b in children.get(id(s), ())
                    if min(b, s.end) > max(a, s.start))
                for s in self.spans}

    def solves(self) -> List[tuple]:
        """``(rows, m, steps)`` of every recorded solve in the order the
        solves returned; reads each solve's steps on the host."""
        done = sorted((s for s in self.spans if s.name == SOLVE), key=lambda s: s.end)
        return [(s.attrs["rows"], s.attrs["m"], int(s.attrs["steps"])) for s in done]

    def summary(self) -> Dict:
        """``calls``; ``host_reads`` by site and ``host_reads_total``;
        ``solves``; ``solve_paths``, the solves by B2 launch path (a solve
        that launched no B2 kernel has none); and by span name its
        ``count``, ``host_s`` (summed
        durations), ``self_s`` and ``device_ms`` (summed
        over spans with CUDA events and no same-named ancestor: a solve
        that calls a solve is counted once; None without events).  Call
        after the device work of the recorded calls is done."""
        own = self.self_seconds()
        spans: Dict[str, Dict] = {}
        for s in self.spans:
            entry = spans.setdefault(s.name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                              "device_ms": None})
            entry["count"] += 1
            entry["host_s"] += s.end - s.start
            entry["self_s"] += own[id(s)]
            if s.events is not None and all(a.name != s.name for a in s.ancestors()):
                entry["device_ms"] = (entry["device_ms"] or 0.0) + s.device_ms()
        paths = Counter(s.attrs["path"] for s in self.spans
                        if s.name == SOLVE and "path" in s.attrs)
        return {"calls": self.calls, "host_reads": dict(self.host_reads),
                "host_reads_total": sum(self.host_reads.values()), "solves": self.solves(),
                "solve_paths": dict(paths), "spans": spans}


class _State:
    """Which recording takes the records, and the open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.recording: Optional[Recording] = None
        self.fresh = True  # the next traced call starts a new recording
        self.blocks = 0  # open recording() blocks
        self.open = 0  # open spans, on every thread
        self.calls = 0
        self.root: Optional[list] = None  # the open stack of the thread that opened the call
        self.annotate = False  # the profiler records this call
        self.nvtx = False

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def innermost(self) -> Optional[Span]:
        stack = self.stack()
        if stack:
            return stack[-1]
        root = self.root
        return root[-1] if root else None


_STATE = _State()


class _Scope:
    """An open span (the context manager :func:`span` returns while on)."""

    __slots__ = ("span", "device", "function")

    def __init__(self, name: str, device, attrs: Dict):
        self.span = Span(name, None, 0, attrs)
        self.device = device
        self.function = None

    def __enter__(self) -> Span:
        global ON
        st, span = _STATE, self.span
        stack = st.stack()
        with st.lock:
            if st.open == 0:
                if st.blocks == 0 and (st.fresh or st.recording is None):
                    st.recording, st.fresh = Recording(), False
                st.calls += 1
                st.recording.calls += 1
                st.root = stack
                st.annotate = _profiler_enabled()
                st.nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
                ON = True
            st.open += 1
            span.parent = st.innermost()
            span.call = st.calls
            st.recording.spans.append(span)
        if span.name == SOLVE:
            span.attrs["pass"] = "bwd" if any(a.name == _GRAD for a in span.ancestors()) else "fwd"
        stack.append(span)
        if st.annotate:
            self.function = torch.autograd.profiler.record_function(span.name)
            self.function.__enter__()
        if st.nvtx:
            torch.cuda.nvtx.range_push(span.name)
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            span.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            span.events[0].record(stream)
        span.start = time.perf_counter()
        return span

    def __exit__(self, *exc) -> bool:
        global ON
        st, span = _STATE, self.span
        if span.events is not None:
            span.events[1].record(torch.cuda.current_stream(self.device))
        span.end = time.perf_counter()
        if st.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.function is not None:
            self.function.__exit__(None, None, None)
        st.stack().pop()
        with st.lock:
            st.open -= 1
            if st.open == 0:
                st.root = None
                ON = st.blocks > 0
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """A span named ``name`` (``with span(...) as record``; ``record`` is
    None while tracing is off).  ``device``: a CUDA device also times the
    span with CUDA events."""
    if not ON:
        return _OFF
    return _Scope(name, device, attrs)


def call(name: str) -> Callable:
    """Decorator: each call of the function is a span named ``name`` that
    turns tracing on for its length while the profiler records."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not ON and not _profiler_enabled():
                _STATE.fresh = True
                return fn(*args, **kwargs)
            with _Scope(name, None, {}):
                return fn(*args, **kwargs)

        return traced

    return wrap


def solve_span(rhs: torch.Tensor, m: int, route: str):
    """The ``cggp.cg.solve`` span of one CG solve of ``rhs``'s rows against
    an [m, m] system, timed on ``rhs``'s device; the site sets
    ``attrs["steps"]`` to the solve's steps tensor.  Only while on."""
    return _Scope(SOLVE, rhs.device, {"rows": int(rhs.shape[-2]), "m": int(m), "route": route})


def solve_path(path: str) -> None:
    """Record kernel B2's launch ``path`` on the innermost open
    ``cggp.cg.solve`` span (none open: nothing).  Only while on."""
    if not ON:
        return
    node = _STATE.innermost()
    while node is not None and node.name != SOLVE:
        node = node.parent
    if node is not None:
        node.attrs["path"] = path


def host_read(value, cast: Callable = bool):
    """``cast(value)``, the read of a device value on the host (``bool``,
    ``int``, ``float``, ``torch.Tensor.cpu``, or a library call that reads
    on the host itself, as ``torch.linalg.eigh`` reads its info flag),
    counted under the reading function while tracing is on."""
    if ON:
        _count_read(sys._getframe(1))
    return cast(value)


def _count_read(frame) -> None:
    site = f"{frame.f_globals.get('__name__', '?')}.{frame.f_code.co_qualname}"
    if site.startswith(_PREFIX):
        site = site[len(_PREFIX):]
    st = _STATE
    with st.lock:
        if st.recording is not None:
            st.recording.host_reads[site] += 1


@contextlib.contextmanager
def recording():
    """Tracing on for the block, without a profiler: yields the block's
    :class:`Recording`."""
    global ON
    st = _STATE
    with st.lock:
        outer, st.recording = st.recording, Recording()
        rec = st.recording
        st.blocks += 1
        ON = True
    try:
        yield rec
    finally:
        with st.lock:
            st.blocks -= 1
            if st.blocks:
                st.recording = outer
            ON = st.blocks > 0 or st.open > 0
            st.fresh = True


def latest() -> Optional[Recording]:
    """The newest recording, None before any."""
    return _STATE.recording
