"""The traced run: host spans around two of the port's host functions, the
``torch.profiler`` trace of the card over the window, and what the
per-layer readers are given.

In a ``--trace 1`` run the harness wraps ``jpeg.native.join_blocks`` and
``jpeg.native.decode_scan`` (module attributes the port looks up at each
call) and each request with spans on the host clock, and profiles the
card's kernels, copies and sets.  Every request of the traced run starts
and ends inside the profile, so each device operation in it belongs to a
request of the run and no attribution is needed.  The host spans move onto
the profiler's clock by the profile's start.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from dataclasses import dataclass



class Spans:
    """Host spans of the traced run, on the host clock (perf_counter):
    (name, thread, start, end)."""

    def __init__(self):
        self.spans = []

    def wrap(self, fn, name: str):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.spans.append((name, threading.get_ident(), t0,
                                   time.perf_counter()))
        return call

    @contextlib.contextmanager
    def around_port(self, native):
        """Wrap the port's host join and host Huffman decode
        (``jpeg.native.join_blocks`` / ``decode_scan``, looked up at each
        call) as ``uhdrbench.host_join`` / ``uhdrbench.host_huffman``;
        restored on exit."""
        saved = {a: getattr(native, a) for a in ("join_blocks",
                                                 "decode_scan")}
        native.join_blocks = self.wrap(saved["join_blocks"],
                                       "uhdrbench.host_join")
        native.decode_scan = self.wrap(saved["decode_scan"],
                                       "uhdrbench.host_huffman")
        try:
            yield
        finally:
            for a, fn in saved.items():
                setattr(native, a, fn)


def profile():
    """A profiler of the card's activity alone: kernels, copies and sets
    (host work is seen through the harness's spans)."""
    import torch
    act = torch.profiler.ProfilerActivity
    # CPU only where there is no card (the tests): no device event then
    return torch.profiler.profile(
        activities=[act.CUDA if torch.cuda.is_available() else act.CPU],
        record_shapes=False, with_stack=False, acc_events=True)


def _ns(e, what: str) -> float:
    """An event's start or duration in ns (`<what>_ns`, or `<what>_us`
    where this PyTorch has only that)."""
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else getattr(e, f"{what}_us")() * 1e3


def device_events(prof):
    """(profiler start in s, [(category, name, start s, end s)]) of the
    card's operations, read from the profiler's Kineto results."""
    kr = prof.profiler.kineto_results
    start = _ns(kr, "trace_start")
    out = []
    for e in kr.events():
        if str(e.device_type()).endswith("CPU"):
            continue
        name = e.name()
        cat = ("gpu_memcpy" if name.startswith("Memcpy") else
               "gpu_memset" if name.startswith("Memset") else "kernel")
        s = _ns(e, "start") * 1e-9
        out.append((cat, name, s, s + _ns(e, "duration") * 1e-9))
    return start * 1e-9, out


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The idle (start, end) gaps of [start, end] outside the intervals."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Op:
    name: str
    cat: str
    start: float       # seconds, profiler clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """What a per-layer reader is given.

    device_ops: kernels, copies and sets on the card; host: CPU ops and
    spans (name, thread, start, end); requests: [(start, end, megapixels)]
    of every request of the traced run, on the host clock;
    outputs: the requests' results (bytes of an encode); cfg, cell: the
    configuration and the workload; peak_bytes_per_s: the card's memory
    bandwidth."""

    device_ops: list
    host: list
    window: tuple
    requests: list
    outputs: list
    cfg: dict
    cell: dict
    peak_bytes_per_s: float = 3.35e12

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def megapixels(self) -> float:
        return sum(r[2] for r in self.requests)

    def kernels(self, pattern: str) -> list:
        """Kernels whose name starts with the symbol `pattern`."""
        rx = re.compile(rf"(^|[ :]){pattern}\b")
        return [o for o in self.device_ops
                if o.cat == "kernel" and rx.search(o.name)]

    def host_spans(self, name: str) -> list:
        return [h for h in self.host if h[0] == name]

    def busy_s(self) -> float:
        w0, w1 = self.window
        return union_length([(max(o.start, w0), min(o.end, w1))
                             for o in self.device_ops
                             if o.end > w0 and o.start < w1])


def build(prof, spans, host_window, requests, outputs, cfg, cell,
          peak) -> Trace:
    """A Trace from the profiler's device events and the harness's host
    spans.  The window starts with the profiler (`host_window[0]` on the
    host clock) and lasts as long as the host saw it; the host spans move
    onto the profiler's clock by that start."""
    start, events = device_events(prof)
    dev = sorted((Op(name, cat, s, t) for cat, name, s, t in events),
                 key=lambda o: o.start)
    shift = start - host_window[0]
    host = [(name, tid, s + shift, t + shift) for name, tid, s, t in spans]
    window = (start, start + host_window[1] - host_window[0])
    return Trace(dev, host, window, requests, outputs, cfg, cell, peak)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost host span or CPU op open at its
    middle on each thread (several threads joined by '|')."""
    by = {}
    for o in tr.device_ops:
        key = o.name if o.cat == "kernel" else o.name.split(" (")[0]
        by[key] = by.get(key, 0.0) + o.seconds
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = tr.window
    idle = gaps([(o.start, o.end) for o in tr.device_ops], w0, w1)
    idle.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in idle[:top]:
        inner = {}
        for name, tid, hs, he in tr.host:
            if not hs <= (s + e) / 2 <= he:
                continue
            if tid not in inner or he - hs < inner[tid][1]:
                inner[tid] = (name, he - hs)
        label = "|".join(sorted(v[0] for v in inner.values())) or "none"
        named.append([label, e - s])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
