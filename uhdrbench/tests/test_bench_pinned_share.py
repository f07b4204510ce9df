"""``download.pinned_share_pct``: the share of the window's
``decode.download`` spans whose ``pinned`` is true, on hand-made spans in
the port's buffer over a synthetic trace; nothing where no span carries
``pinned`` (the port before its pinned download)."""

import pytest

from libultrahdr_tpu_torch.utils import profiling
from uhdrbench import harness, trace

T0 = 1_790_000_000          # seconds on the profiler's (Unix) clock


@pytest.fixture(autouse=True)
def empty():
    profiling.clear()
    yield
    profiling.clear()


def put(i, start, name="decode.download", **attrs):
    ns = T0 * 10 ** 9 + round(start * 1e9)
    profiling._record(profiling.Span(name, ns, ns + 10 ** 6, 0, i, None, i,
                                     1, attrs))


def read():
    tr = trace.Trace([], [], (T0, T0 + 1.0), [(0.0, 0.1, 1.0)], [], {}, {})
    return harness.metric_reader("download.pinned_share_pct")(tr)


def test_nothing_without_the_attribute():
    assert read() is None
    put(1, 0.1, what="output", bytes=8)
    put(2, 0.2, what="map", bytes=2)
    put(3, 0.3, name="decode.huffman", image="base", pinned=True)
    assert read() is None


@pytest.mark.parametrize("pinned,want", [
    ((False, False), 0.0), ((True, False), 50.0), ((True, True), 100.0),
    ((True, True, True, False), 75.0)])
def test_share_of_pinned_downloads(pinned, want):
    for i, p in enumerate(pinned):
        put(1 + i, 0.1 + 0.1 * i, what=("output", "map")[i % 2], bytes=8,
            pinned=p)
    put(90, -1.0, what="output", bytes=8, pinned=not pinned[0])  # before
    put(91, 2.0, what="map", bytes=8, pinned=not pinned[0])      # after
    assert read() == pytest.approx(want)
