"""Request spans and gated logging.

Port of ``libultrahdr_tpu/utils/profiling.py``, whose per-stage sums this
replaces with spans.  ``stage(name, **attrs)`` records a span while a
``torch.profiler`` session is active and nothing at any other time: its
start and end in ns on the profiler's clock (``time.time_ns``, the Unix
epoch, which Kineto's event timestamps use), the thread's CPU ns over it,
its parent span and a request id.  Spans nest per thread; the outermost
span of a thread opens a new request.  ``attrs`` hold counters taken at the
boundary (bytes, image, MCUs).  Read them with ``spans()`` and
``stage_report()``.  Enable the logs with UHDR_TPU_LOGS=1, the run-time
analog of the reference's UHDR_ENABLE_LOGS compile flag
(ultrahdrcommon.h:34-118).

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        UhdrDecoder().decode(...)
    profiling.spans()          # [Span(name="decode.huffman", ...), ...]
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _torch_profiler

MAX_SPANS = 1_000_000

_local = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)
_lock = threading.Lock()
_spans: list = []
_dropped = 0

_logger = None


class Span(NamedTuple):
    name: str
    start_ns: int           # time.time_ns(), the profiler's clock
    end_ns: int
    cpu_ns: int             # the thread's CPU time over the span
    span_id: int
    parent_id: int | None   # the enclosing span on the same thread
    request_id: int         # opened by the thread's outermost span
    thread: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Recorder:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "request_id",
                 "start_ns", "cpu0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> dict:
        stack = _local.__dict__.setdefault("stack", [])
        self.span_id = next(_ids)
        if stack:
            self.parent_id, self.request_id = stack[-1]
        else:
            self.parent_id, self.request_id = None, next(_requests)
        stack.append((self.span_id, self.request_id))
        self.cpu0 = time.thread_time_ns()
        self.start_ns = time.time_ns()
        return self.attrs

    def __exit__(self, *exc):
        end = time.time_ns()
        cpu = time.thread_time_ns() - self.cpu0
        _local.stack.pop()
        _record(Span(self.name, self.start_ns, end, cpu, self.span_id,
                     self.parent_id, self.request_id, threading.get_ident(),
                     self.attrs))
        return False


def _record(span: Span):
    global _dropped
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(span)
        else:
            _dropped += 1


def stage(name: str, **attrs):
    """A span named `name` around the ``with`` block, recorded while a
    ``torch.profiler`` session is active; the block gets `attrs`, and
    counters it adds there are kept with the span.

    Device work is asynchronous: a span that only queues launches holds
    the host's dispatch time, and the card's time lands in the span that
    waits for a result."""
    # the session's process-wide flag: torch._C._autograd._profiler_enabled()
    # is thread-local, False on threads the session did not start on
    if not _torch_profiler._is_profiler_enabled:
        return contextlib.nullcontext(attrs)
    return _Recorder(name, attrs)


def spans() -> list[Span]:
    """The recorded spans, in the order they ended."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Spans not kept since the last ``clear()``: the buffer was full."""
    return _dropped


def clear():
    """Empty the buffer and zero the dropped count."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def stage_report() -> dict[str, tuple[int, float]]:
    """{span name: (calls, total seconds)} of the recorded spans."""
    out: dict[str, tuple[int, float]] = {}
    for s in spans():
        n, t = out.get(s.name, (0, 0.0))
        out[s.name] = (n + 1, t + s.seconds)
    return out


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("libultrahdr_tpu_torch")
        if os.environ.get("UHDR_TPU_LOGS", "0") not in ("0", ""):
            _logger.setLevel(logging.DEBUG)
            if not _logger.handlers:
                h = logging.StreamHandler()
                h.setFormatter(logging.Formatter(
                    "%(asctime)s %(name)s %(levelname)s %(message)s"))
                _logger.addHandler(h)
        else:
            _logger.addHandler(logging.NullHandler())
    return _logger
