"""The readers of the port's own spans and counters
(``libultrahdr_tpu_torch.utils.profiling``): their arithmetic on hand-made
spans in the port's buffer over a synthetic trace, their silence where the
port records no span, and a traced decode run on the CPU."""

import pytest

from libultrahdr_tpu_torch.utils import profiling
from uhdrbench import harness, trace

SPAN_METRICS = ["huffman.span_ms_per_mp", "upload.host_ms_per_mp",
                "dispatch.host_ms_per_mp", "download.wait_ms_per_mp",
                "download.copy_ms_per_mp", "copy.d2h_mb_per_image",
                "idle.unattributed_pct"]
T0 = 1_790_000_000          # seconds on the profiler's (Unix) clock
_ids = iter(range(1, 10 ** 6))


@pytest.fixture(autouse=True)
def empty():
    profiling.clear()
    yield
    profiling.clear()


def put(name, t0, t1, thread, request, parent=None, **attrs):
    """A span from t0 to t1 s after T0 into the port's buffer."""
    sid = next(_ids)
    profiling._record(profiling.Span(
        name, T0 * 10 ** 9 + round(t0 * 1e9), T0 * 10 ** 9 + round(t1 * 1e9),
        0, sid, parent, request, thread, attrs))
    return sid


def synthetic(window=(0.0, 1.0), busy=(), requests=2, mp=2.0):
    ops = [trace.Op("k", "kernel", T0 + s, T0 + e) for s, e in busy]
    return trace.Trace(ops, [], (T0 + window[0], T0 + window[1]),
                       [(0.0, 0.1, mp)] * requests, [], {}, {})


def request(offset, thread, request_id):
    """One decode's chain, `offset` s into the window."""
    def at(name, t0, t1, **attrs):
        put(name, offset + t0, offset + t1, thread, request_id, root,
            **attrs)
    root = put("decode", offset, offset + 0.4, thread, request_id)
    at("decode.parse", 0.0, 0.02, bytes=5)
    at("decode.parse", 0.05, 0.06, bytes=5)
    at("decode.huffman", 0.06, 0.16, image="base", mcus=48)
    at("decode.huffman", 0.16, 0.18, image="map", mcus=12)
    at("decode.upload", 0.18, 0.19, bytes=100)
    at("decode.upload", 0.19, 0.195, bytes=20)
    at("decode.dispatch", 0.195, 0.205)
    at("decode.wait", 0.205, 0.30, what="output")
    at("decode.download", 0.30, 0.33, what="output", bytes=8_000_000)
    at("decode.wait", 0.33, 0.331, what="map")
    at("decode.download", 0.331, 0.341, what="map", bytes=1_000_000)


def test_span_readers_arithmetic():
    request(0.0, 1, 1)
    request(0.25, 2, 2)
    # an earlier session's span, before the window: not read
    put("decode.huffman", -2.0, -1.0, 1, 0, image="base", mcus=48)
    tr = synthetic()
    got = {m: harness.metric_reader(m)(tr) for m in SPAN_METRICS[:6]}
    # per MP: 2 requests of 2 MP
    assert got == pytest.approx({
        "huffman.span_ms_per_mp": 1e3 * 2 * 0.12 / 4,
        "upload.host_ms_per_mp": 1e3 * 2 * 0.015 / 4,
        "dispatch.host_ms_per_mp": 1e3 * 2 * 0.01 / 4,
        "download.wait_ms_per_mp": 1e3 * 2 * 0.096 / 4,
        "download.copy_ms_per_mp": 1e3 * 2 * 0.04 / 4,
        "copy.d2h_mb_per_image": 9.0}, rel=1e-6)


def test_unattributed_idle_over_two_threads():
    # idle: [0, .2], [.3, .6], [.7, 1]: 0.8 s
    busy = [(0.2, 0.3), (0.6, 0.7)]
    a = put("decode", 0.0, 0.5, 1, 1)
    put("decode.huffman", 0.0, 0.1, 1, 1, a)
    put("decode.wait", 0.25, 0.35, 1, 1, a)
    b = put("decode", 0.4, 0.9, 2, 2)
    put("decode.huffman", 0.05, 0.15, 2, 2, b)
    put("decode.parse", 0.45, 0.5, 2, 2, b)
    put("decode.download", 0.55, 0.65, 2, 2, b)
    # the spans below `decode`, on either thread, cover 0.15 + 0.15 of the
    # idle time: [0, .15]; [.3, .35], [.45, .5], [.55, .6]
    read = harness.metric_reader("idle.unattributed_pct")
    assert read(synthetic(busy=busy)) == pytest.approx(100 * 0.5 / 0.8)
    assert read(synthetic(busy=[])) is None          # no device trace
    profiling.clear()
    put("decode", 0.0, 0.5, 1, 1)
    assert read(synthetic(busy=busy)) is None        # no span below


def test_readers_silent_without_port_spans(monkeypatch):
    request(0.0, 1, 1)
    tr = synthetic(busy=[(0.2, 0.3)])
    assert all(harness.metric_reader(m)(tr) is not None
               for m in SPAN_METRICS)
    monkeypatch.delattr(profiling, "spans")
    assert [harness.metric_reader(m)(tr) for m in SPAN_METRICS] == \
        [None] * len(SPAN_METRICS)


def test_readers_silent_outside_the_window():
    request(5.0, 1, 1)
    tr = synthetic(busy=[(0.2, 0.3)])
    assert [harness.metric_reader(m)(tr) for m in SPAN_METRICS] == \
        [None] * len(SPAN_METRICS)


@pytest.mark.parametrize("cell", ["android_12mp.decode_hlg_c1",
                                  "libdefault_12mp.decode_pq_c4"])
def test_traced_cpu_run_counts_the_downloads(cell):
    size = (256, 192)
    _, cfg = harness.load_cell(cell)
    k = cfg["map_scale"]
    map_bytes = (3 if cfg["multichannel_map"] else 1) \
        * (size[0] // k) * (size[1] // k)
    res = harness.run_cell(cell, 2 ** 31 + 9, 1.0, True, device="cpu",
                           size=size, out=lambda s: None,
                           err=lambda s: None)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["copy.d2h_mb_per_image"] == pytest.approx(
        (size[0] * size[1] * 4 + map_bytes) / 1e6, rel=1e-12)
    # the span holds the harness's wrapper of the C++ decode
    assert m["huffman.span_ms_per_mp"] >= 0.9 * m["host_huffman.ms_per_mp"]
    assert m["upload.host_ms_per_mp"] > 0 and m["dispatch.host_ms_per_mp"] > 0
    # no card: nothing waits, and the device trace is empty
    assert "download.wait_ms_per_mp" not in m
    assert "idle.unattributed_pct" not in m
