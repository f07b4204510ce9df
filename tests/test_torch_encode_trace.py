"""The encode chain's spans (``utils/profiling.stage``): named and nested
under the request's ``encode`` span, their byte counters equal to the
tensors and scans they count, recorded only under ``torch.profiler``, and
no encoded byte changed by them; the benchmark's readers of those spans
on synthetic spans.  CPU, except the ``card`` test, which skips without a
CUDA card."""

import collections
import struct
import threading

import pytest
import torch

from libultrahdr_tpu_torch import api, fused, testing
from libultrahdr_tpu_torch.jpeg import device_entropy
from libultrahdr_tpu_torch.types import ColorTransfer, EncPreset, ImgLabel
from libultrahdr_tpu_torch.utils import profiling

W, H = 256, 192
ACT = torch.profiler.ProfilerActivity
# (transfer, map scale, 3-channel map, preset, map quality): the Android
# camera's settings and the library's defaults
SETTINGS = {"android": (ColorTransfer.HLG, 4, False, EncPreset.REALTIME, 85),
            "libdefault": (ColorTransfer.PQ, 1, True,
                           EncPreset.BEST_QUALITY, 95)}
CHAIN = {"encode": 1, "encode.upload": 1, "encode.dispatch": 2,
         "encode.join": 1, "encode.download": 1, "encode.assemble": 1}


@pytest.fixture
def empty():
    profiling.clear()
    yield
    profiling.clear()


def encoder(setting: str, device: str = "cpu") -> api.UhdrEncoder:
    ct, scale, multi, preset, mq = SETTINGS[setting]
    img = testing.photo_p010(W, H)
    img.ct = ct
    enc = api.UhdrEncoder(device=device)
    enc.set_raw_image(img, ImgLabel.HDR)
    enc.set_quality(95, ImgLabel.BASE)
    enc.set_quality(mq, ImgLabel.GAIN_MAP)
    enc.set_gainmap_scale_factor(scale)
    enc.set_using_multi_channel_gainmap(multi)
    enc.set_preset(preset)
    return enc


def cpu_profile():
    return torch.profiler.profile(activities=[ACT.CPU])


def scan_sizes(data: bytes) -> list[int]:
    """Bytes between each SOS header and the next EOI of a JPEG_R."""
    out, pos = [], 0
    while (sos := data.find(b"\xff\xda", pos)) >= 0:
        start = sos + 2 + struct.unpack_from(">H", data, sos + 2)[0]
        end = data.find(b"\xff\xd9", start)
        out.append(end - start)
        pos = end + 2
    return out


def test_no_profiler_records_nothing(empty):
    encoder("libdefault").encode()
    assert profiling.spans() == []
    assert profiling.stage_report() == {}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_encode_records_the_chain(setting, empty):
    with cpu_profile():
        encoder(setting).encode()
    got = profiling.spans()
    assert collections.Counter(s.name for s in got) == CHAIN
    by_id = {s.span_id: s for s in got}
    (root,) = [s for s in got if s.parent_id is None]
    assert root.name == "encode"
    assert root.attrs == {"fmt": "P010",
                          "map_channels": 3 if SETTINGS[setting][2] else 1}
    for s in got:
        assert s.request_id == root.request_id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert s is root or by_id[s.parent_id] is root
    order = [s.name for s in sorted(got, key=lambda s: s.start_ns)][1:]
    assert order == ["encode.upload", "encode.dispatch", "encode.dispatch",
                     "encode.join", "encode.download", "encode.assemble"]
    assert [s.attrs["what"] for s in sorted(
        (s for s in got if s.name == "encode.dispatch"),
        key=lambda s: s.start_ns)] == ["pixels", "scans"]
    (join,) = [s for s in got if s.name == "encode.join"]
    assert join.attrs == {"engine": "device"}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_byte_counters(setting, empty, monkeypatch):
    packed = []
    orig = fused._pack_scans

    def keep(scans, pack):
        out = orig(scans, pack)
        packed.append((out, [lay for _, lay in scans]))
        return out
    monkeypatch.setattr(fused, "_pack_scans", keep)
    with cpu_profile():
        data = encoder(setting).encode()
    got = {}
    for s in sorted(profiling.spans(), key=lambda s: s.start_ns):
        got.setdefault(s.name, []).append(s.attrs.get("bytes"))
    ((words, blen), layouts), = packed
    n_blocks = sum(lay.mcus_h * lay.bpr for lay in layouts)
    assert blen.numel() == n_blocks
    assert words.numel() == device_entropy.total_words(blen.numpy())
    assert got["encode.upload"] == [W * H * 2 + (H // 2) * W * 2]
    assert got["encode.download"] == [sum(scan_sizes(data))]
    assert got["encode.join"] == [None]
    assert got["encode.assemble"] == [len(data)]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_tracing_changes_no_byte(setting, empty):
    plain = encoder(setting).encode()
    with cpu_profile():
        traced = encoder(setting).encode()
    assert profiling.spans()
    assert traced == plain


def test_threads_open_their_own_requests(empty):
    start = threading.Barrier(3)
    outs = []

    def client():
        start.wait(timeout=60)
        outs.append(encoder("android").encode())

    with cpu_profile():
        threads = [threading.Thread(target=client) for _ in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    assert len(outs) == 3 and len(set(outs)) == 1
    got = profiling.spans()
    roots = [s for s in got if s.parent_id is None]
    assert {s.name for s in roots} == {"encode"}
    assert len({s.request_id for s in roots}) == 3
    assert len(got) == 3 * sum(CHAIN.values())


# ---------------------------------------------------------------------------
# the benchmark's readers of the encode spans

T0 = 1_790_000_000
READERS = {
    # reader: the span whose time it sums per megapixel
    "encode_upload.host_ms_per_mp": "encode.upload",
    "encode_wait.ms_per_mp": "encode.wait",
    "encode_download.copy_ms_per_mp": "encode.download",
    "encode_join.host_ms_per_mp": "encode.join",
    "encode_assemble.host_ms_per_mp": "encode.assemble",
}


def put(name, i, start, ms, parent=None, **attrs):
    ns = T0 * 10 ** 9 + round(start * 1e9)
    profiling._record(profiling.Span(name, ns, ns + round(ms * 1e6), 0, i,
                                     parent, 1, 1, attrs))


def trace_of(mp_each=2.0, requests=2):
    from uhdrbench import trace
    return trace.Trace([], [], (T0, T0 + 1.0),
                       [(0.0, 0.1, mp_each)] * requests, [], {}, {})


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader(metric, empty):
    from uhdrbench import harness
    read = harness.metric_reader(metric)
    tr = trace_of()
    assert read(tr) is None
    put("encode.other", 1, 0.1, 50.0)
    assert read(tr) is None
    put(READERS[metric], 2, 0.2, 3.0)
    put(READERS[metric], 3, 0.5, 5.0)
    put(READERS[metric], 4, -1.0, 7.0)        # before the window
    assert read(tr) == pytest.approx(8.0 / 4.0)


def test_dispatch_reader_leaves_out_the_wait(empty):
    from uhdrbench import harness
    read = harness.metric_reader("encode_dispatch.host_ms_per_mp")
    tr = trace_of()
    assert read(tr) is None
    put("encode.wait", 1, 0.1, 50.0)
    assert read(tr) is None
    put("encode.dispatch", 2, 0.2, 3.0, what="pixels")
    put("encode.dispatch", 3, 0.3, 9.0, what="scans")
    put("encode.wait", 4, 0.305, 4.0, parent=3)
    assert read(tr) == pytest.approx((3.0 + 9.0 - 4.0) / 4.0)


def test_d2h_reader(empty):
    from uhdrbench import harness
    read = harness.metric_reader("encode.d2h_mb_per_image")
    tr = trace_of(requests=4)
    assert read(tr) is None
    put("decode.download", 1, 0.1, 1.0, bytes=10 ** 9)
    assert read(tr) is None
    for i in range(4):
        put("encode.download", 2 + i, 0.2 + 0.1 * i, 1.0,
            bytes=3_000_000 + i)
    assert read(tr) == pytest.approx((12_000_000 + 6) / 1e6 / 4)


@pytest.mark.card
def test_card_encode_waits_inside_the_dispatch(empty):
    """On the card the request's one wait for the card is an
    ``encode.wait`` span under the request's ``encode`` span, after the
    scans' ``encode.dispatch`` and the join's launches (``encode.join``,
    `engine` "device") and before the download of the joined scans, and
    the bytes are those of the untraced encode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want = encoder("libdefault", "cuda").encode()
    with torch.profiler.profile(activities=[ACT.CUDA]):
        got = encoder("libdefault", "cuda").encode()
    assert got == want
    spans = profiling.spans()
    (wait,) = [s for s in spans if s.name == "encode.wait"]
    parent = next(s for s in spans if s.span_id == wait.parent_id)
    assert parent.name == "encode"
    (scans,) = [s for s in spans if s.name == "encode.dispatch"
                and s.attrs == {"what": "scans"}]
    (join,) = [s for s in spans if s.name == "encode.join"]
    (down,) = [s for s in spans if s.name == "encode.download"]
    assert join.attrs == {"engine": "device"}
    assert scans.end_ns <= join.start_ns <= join.end_ns <= wait.start_ns
    assert wait.end_ns <= down.start_ns
    assert down.attrs["bytes"] == sum(scan_sizes(got))
