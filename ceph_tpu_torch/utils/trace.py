"""Span tracing + historic-op ring — the ZTracer/OpTracker analog —
and per-name host accounting.

The reference threads ``ZTracer::Trace`` handles through the EC
pipeline signatures (osd/ECBackend.h:70-94) and keeps an in-memory
history of completed ops served as ``dump_historic_ops``
(common/TrackedOp). Here: a context-manager ``span`` records name,
parent, wall duration, and tags into a bounded ring; nesting is
tracked per-thread so pipeline code never passes handles explicitly.

Every span, and every ``timer`` (per-frame and per-commit work that
would flood the ring), also adds to the process-wide ``trace`` perf
counter set: for each name of ``SPAN_NAMES``, ``<name>.count``,
``<name>.wall_s`` (inclusive), ``<name>.self_s`` (wall minus the
children closed on the same thread) and ``<name>.cpu_s`` (the thread's
own CPU, ``time.thread_time()``, minus its children's). ``<remote>``
markers count nothing and take no child time. A name outside
``SPAN_NAMES`` raises.

While a torch profiler runs, spans and timers also open
``torch.profiler.record_function`` ranges. A default
``torch.profiler.profile`` records ranges only from the thread that
started it; ranges from the OSD workers and messenger threads appear
beside the card's kernels only in a capture built with
``torch._C._profiler._ExperimentalConfig(profile_all_threads=True)``.
Start times are on ``time.perf_counter()``.
"""

from __future__ import annotations

import itertools
import os
import secrets
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

from .perf_counters import (
    PerfCountersBuilder,
    PerfCountersCollection,
    perf_collection,
)

#: process-unique prefix so trace ids stay distinct across the DCN
#: tier's OS-process hosts (the blkin trace-id role)
_TRACE_PREFIX = f"{os.getpid():x}-{secrets.token_hex(2)}"

#: torch.profiler.record_function, resolved ONCE on first span instead
#: of an import+try/except per span (the per-span import dominated
#: small-op span cost). Lazy rather than import-time so importing this
#: module does not import torch. Sentinel False = unresolved; None =
#: resolved-absent.
_ANNOTATION_CLS: "object" = False
#: ``torch.autograd.profiler``, whose process-wide
#: ``_is_profiler_enabled`` is true while a torch profiler runs
_PROFILER: "object" = None


def _annotation_cls():
    """``record_function`` while a torch profiler runs, else None.
    Outside a capture a range records nothing, yet its two op calls
    cost tens of µs and hand the GIL to another thread twice, which
    a thread of a busy daemon then waits to get back."""
    global _ANNOTATION_CLS, _PROFILER
    if _ANNOTATION_CLS is False:
        try:
            import torch.autograd.profiler
            import torch.profiler

            _ANNOTATION_CLS = torch.profiler.record_function
            _PROFILER = torch.autograd.profiler
        except Exception:
            _ANNOTATION_CLS = None
    if _ANNOTATION_CLS is None or not getattr(
        _PROFILER, "_is_profiler_enabled", True
    ):
        return None
    return _ANNOTATION_CLS


@dataclass
class Span:
    #: globally unique (process-prefixed) — parent links survive
    #: merging dump_historic output across host processes, where
    #: bare per-process counters would collide
    span_id: str
    parent_id: str | None
    name: str
    start: float
    duration: float | None = None
    tags: dict = field(default_factory=dict)
    #: one id per END-TO-END operation, carried across the wire
    #: (client op -> primary -> replica sub-ops all share it)
    trace_id: str | None = None
    #: monotonic clock at span open, taken at the SAME instant as the
    #: wall-clock ``start``: trace assembly orders spans and computes
    #: intervals on (start_mono, start_mono + duration) within a
    #: process — mixing wall starts with perf_counter durations made
    #: cross-thread ordering wobble by the wall clock's granularity
    start_mono: float | None = None

    def as_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "start_mono": self.start_mono,
            "duration": self.duration,
            "tags": self.tags,
            "trace_id": self.trace_id,
        }


#: every name a span or timer may carry. Spans (ring entries, read by
#: ``trace_assembly`` and ``dump_historic``) come first, then the
#: timers (counted only).
SPAN_NAMES = (
    "client_op",
    "osd_op",
    "osd_op_submit",
    "sub_write",
    "sub_read",
    "ec_write",
    "ec_reconstruct",
    "ec_recover",
    "msg_encode",
    "msg_send",
    "msg_decode",
    "ec_stage",
    "ec_encode",
    "ec_decode",
    "store_commit",
    "store_read",
)
#: the four ``trace`` counter keys of a name, ``<name>.<stat>``
SPAN_STATS = ("count", "wall_s", "self_s", "cpu_s")


def _make_counters(collection: PerfCountersCollection):
    b = PerfCountersBuilder(collection, "trace")
    for name in SPAN_NAMES:
        b.add_u64_counter(f"{name}.count", f"{name}: closes")
        b.add_time(f"{name}.wall_s", f"{name}: inclusive wall seconds")
        b.add_time(f"{name}.self_s", f"{name}: wall minus children")
        b.add_time(f"{name}.cpu_s", f"{name}: thread CPU minus children")
    return b.create_perf_counters()


class _Timer:
    """One open span or timer: its accounting frame (the children's
    wall and CPU seconds, added as they close on this thread), its
    profiler range and its start clocks."""

    __slots__ = ("tracer", "name", "child_wall", "child_cpu", "range",
                 "t0", "c0")

    def __init__(self, tracer: "Tracer", name: str) -> None:
        self.tracer = tracer
        self.name = name
        self.child_wall = 0.0
        self.child_cpu = 0.0

    def __enter__(self) -> "_Timer":
        self.tracer._frames().append(self)
        self.range = None
        cls = _annotation_cls()
        if cls is not None:
            try:
                self.range = cls(self.name)
                self.range.__enter__()
            except Exception:
                self.range = None
        self.t0 = time.perf_counter()
        self.c0 = time.thread_time()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> float:
        """Close the range, charge the counters, return wall seconds."""
        cpu = time.thread_time() - self.c0
        wall = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(None, None, None)
        frames = self.tracer._frames()
        frames.pop()
        if frames:
            frames[-1].child_wall += wall
            frames[-1].child_cpu += cpu
        count, wall_k, self_k, cpu_k = self.tracer._keys[self.name]
        self.tracer.counters.add_many((
            (count, 1), (wall_k, wall), (self_k, wall - self.child_wall),
            (cpu_k, cpu - self.child_cpu),
        ))
        return wall


_NULL_TIMER = nullcontext()


class Tracer:
    def __init__(self, history: int = 512, enabled: bool = True,
                 collection=None) -> None:
        """``collection``: the perf collection that serves this
        tracer's ``trace`` counter set (the process tracer's is
        ``perf_collection``); None keeps the set private."""
        self.enabled = enabled
        self._ids = itertools.count(1)
        self._history: deque[Span] = deque(maxlen=history)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.counters = _make_counters(
            collection if collection is not None
            else PerfCountersCollection()
        )
        self._keys = {
            name: tuple(f"{name}.{stat}" for stat in SPAN_STATS)
            for name in SPAN_NAMES
        }

    def _stack(self) -> list[Span]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def _frames(self) -> list[_Timer]:
        try:
            return self._tls.frames
        except AttributeError:
            self._tls.frames = []
            return self._tls.frames

    def _check(self, name: str) -> None:
        if name not in self._keys:
            raise ValueError(f"span name {name!r} is not in SPAN_NAMES")

    def timer(self, name: str):
        """Count one piece of work under ``name`` (the four ``trace``
        keys and a profiler range) without a span id or a ring entry."""
        self._check(name)
        if not self.enabled:
            return _NULL_TIMER
        return _Timer(self, name)

    @contextmanager
    def span(self, name: str, **tags):
        self._check(name)
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        trace_id = (
            stack[-1].trace_id
            if stack
            else f"{_TRACE_PREFIX}-{next(self._ids)}"
        )
        timer = _Timer(self, name)
        timer.__enter__()
        sp = Span(
            f"{_TRACE_PREFIX}-{next(self._ids)}", parent, name,
            time.time(), tags=tags, trace_id=trace_id,
            start_mono=timer.t0,
        )
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.duration = timer.close()
            stack.pop()
            with self._lock:
                self._history.append(sp)

    def current(self) -> tuple[str | None, str | None]:
        """(trace_id, span_id) of the innermost open span — what a
        sender stamps into an outgoing message."""
        stack = self._stack()
        if not stack:
            return None, None
        return stack[-1].trace_id, stack[-1].span_id

    @contextmanager
    def continue_trace(self, trace_id: str | None, parent_id: str | None):
        """Adopt a REMOTE trace context (the wire hop of
        ZTracer/blkin: the reference threads trace handles through the
        EC pipeline signatures and the sub-op messages,
        osd/ECBackend.h:70-94). Spans opened inside link to the
        sender's span and share its trace id, so one client op's
        spans correlate across the client, the primary, and every
        replica — dump_historic filtered by trace_id IS the
        distributed trace."""
        if not self.enabled or trace_id is None:
            yield
            return
        stack = self._stack()
        marker = Span(
            parent_id if parent_id is not None else "",
            None, "<remote>", time.time(), trace_id=trace_id,
        )
        stack.append(marker)
        try:
            yield
        finally:
            stack.pop()

    def dump_historic(self, limit: int | None = None) -> list[dict]:
        with self._lock:
            spans = list(self._history)
        if limit is not None:
            spans = spans[-limit:]
        return [s.as_dict() for s in spans]

    def clear(self) -> None:
        with self._lock:
            self._history.clear()


# Process-global tracer; its counters are the ``trace`` set of
# ``perf dump``.
tracer = Tracer(collection=perf_collection)
