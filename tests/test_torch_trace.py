"""The port's span recorder (``utils/profiling.py``) and the decode chain's
spans: recorded only under ``torch.profiler``, on the profiler's clock,
one request a thread's outermost span, bounded.  CPU, except the ``card``
test, which skips without a CUDA card."""

import collections
import threading
import time

import pytest
import torch

from libultrahdr_tpu_torch import api, testing
from libultrahdr_tpu_torch.types import ColorTransfer, ImgFmt, ImgLabel
from libultrahdr_tpu_torch.utils import profiling

W, H = 256, 192
ACT = torch.profiler.ProfilerActivity


@pytest.fixture(scope="module")
def jpegr():
    enc = api.UhdrEncoder(device="cpu")
    enc.set_raw_image(testing.photo_p010(W, H), ImgLabel.HDR)
    return enc.encode()


@pytest.fixture
def empty():
    profiling.clear()
    yield
    profiling.clear()


def decode(data):
    dec = api.UhdrDecoder(device="cpu")
    dec.set_image(data)
    dec.set_out_color_transfer(ColorTransfer.HLG)
    dec.set_out_img_format(ImgFmt.RGBA1010102)
    dec.decode()
    return dec


def cpu_profile():
    return torch.profiler.profile(activities=[ACT.CPU])


def test_no_profiler_records_nothing(jpegr, empty):
    before = profiling.stage_report()
    decode(jpegr)
    with profiling.stage("decode.parse", bytes=1) as attrs:
        attrs["more"] = 2
    assert profiling.spans() == []
    assert profiling.stage_report() == before == {}


def test_decode_records_the_chain(jpegr, empty):
    with cpu_profile():
        dec = decode(jpegr)
    got = profiling.spans()
    assert collections.Counter(s.name for s in got) == {
        "decode": 1, "decode.parse": 1, "decode.huffman": 2,
        "decode.upload": 2, "decode.dispatch_wait": 1, "decode.dispatch": 1,
        "decode.download": 2}
    by_id = {s.span_id: s for s in got}
    (root,) = [s for s in got if s.parent_id is None]
    assert root.name == "decode"
    assert root.attrs == {"transfer": "HLG", "w": W, "h": H}
    for s in got:
        assert s.request_id == root.request_id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert 0 <= s.cpu_ns
        up = s
        while up.parent_id is not None:
            up = by_id[up.parent_id]
        assert up is root
    huff = sorted((s for s in got if s.name == "decode.huffman"),
                  key=lambda s: s.start_ns)
    assert [s.attrs["image"] for s in huff] == ["base", "map"]
    gm = dec.get_decoded_gainmap_image()
    assert [s.attrs["mcus"] for s in huff] == [
        (W // 16) * (H // 16), -(-gm.w // 8) * -(-gm.h // 8)]
    down = {s.attrs["what"]: s.attrs["bytes"] for s in got
            if s.name == "decode.download"}
    assert down == {"output": W * H * 4, "map": gm.planes[0].nbytes}
    parse = [s.attrs["bytes"] for s in got if s.name == "decode.parse"]
    assert parse == [len(jpegr)]
    rep = profiling.stage_report()
    assert {k: v[0] for k, v in rep.items()} == {
        "decode": 1, "decode.parse": 1, "decode.huffman": 2,
        "decode.upload": 2, "decode.dispatch_wait": 1, "decode.dispatch": 1,
        "decode.download": 2}
    assert rep["decode"][1] == pytest.approx(root.seconds)


def test_threads_open_their_own_requests(jpegr, empty):
    start = threading.Barrier(4)

    def client():
        start.wait(timeout=60)
        decode(jpegr)

    with cpu_profile():
        threads = [threading.Thread(target=client) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    got = profiling.spans()
    roots = [s for s in got if s.parent_id is None]
    assert len(roots) == 4 and {s.name for s in roots} == {"decode"}
    assert len({s.request_id for s in roots}) == 4
    assert len({s.thread for s in roots}) == 4
    by_id = {s.span_id: s for s in got}
    for s in got:
        if s.parent_id is not None:
            assert by_id[s.parent_id].thread == s.thread
            assert by_id[s.parent_id].request_id == s.request_id
    assert len(got) == 4 * 10


def test_span_on_the_profilers_clock(empty):
    tol = 0.5e6
    with cpu_profile() as prof:
        with torch.profiler.record_function("uhdr.warm"):
            pass
        with profiling.stage("outer"):
            with torch.profiler.record_function("uhdr.clock"):
                time.sleep(0.02)
    (span,) = profiling.spans()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "uhdr.clock"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert 0 <= start - span.start_ns <= tol
    assert 0 <= span.end_ns - end <= tol


def test_buffer_bound_and_dropped(monkeypatch, empty):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with cpu_profile():
        for i in range(5):
            with profiling.stage("s", i=i):
                pass
    assert [s.attrs["i"] for s in profiling.spans()] == [0, 1, 2]
    assert profiling.dropped() == 2
    assert profiling.stage_report()["s"][0] == 3
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


@pytest.mark.card
def test_span_encloses_the_card_kernel(empty):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tol = 0.5e6
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ACT.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with profiling.stage("sleep"):
            torch.cuda._sleep(50_000_000)
            torch.cuda.synchronize()
    span = next(s for s in profiling.spans() if s.name == "sleep")
    ev = max((e for e in prof.profiler.kineto_results.events()
              if not str(e.device_type()).endswith("CPU")),
             key=lambda e: e.duration_ns())
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    print(f"{ev.name()} {ev.duration_ns() / 1e6:.3f} ms; span opens "
          f"{(start - span.start_ns) / 1e6:.4f} ms before it, closes "
          f"{(span.end_ns - end) / 1e6:.4f} ms after it")
    assert 0 <= start - span.start_ns <= tol
    assert 0 <= span.end_ns - end <= tol
