"""The decode's download into pinned host memory (``jpegr._download``): the
count of live pinned result bytes against ``PINNED_CAP_BYTES`` and the
``pinned`` attribute of the ``decode.download`` spans, on the CPU; on the
card (``card`` tests, skipped without one; run ``python -m pytest
--noconftest -q tests/test_torch_pinned_download.py -m card``) the pinned
result against the pageable ``.cpu()`` bit for bit, its memory, the cap, the
count's release, the host re-decode after a faulty card scan, and four
threads at once.  Imports no JAX."""

import gc
import random
import sys
import threading

import numpy as np
import pytest
import torch

from libultrahdr_tpu_torch import api, fused, jpegr, testing
from libultrahdr_tpu_torch.jpeg import huffman_kernel as hk
from libultrahdr_tpu_torch.jpeg.decoder import parse_jpeg
from libultrahdr_tpu_torch.jpegr import JpegR
from libultrahdr_tpu_torch.types import ColorTransfer, ImgFmt, ImgLabel
from libultrahdr_tpu_torch.utils import profiling

CT = ColorTransfer


@pytest.fixture
def empty():
    profiling.clear()
    yield
    profiling.clear()


def downloads():
    """(what, pinned) of the recorded ``decode.download`` spans."""
    return [(s.attrs["what"], s.attrs["pinned"]) for s in profiling.spans()
            if s.name == "decode.download"]


def traced():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# ---------------------------------------------------------------------------
# the CPU

def test_cpu_downloads_say_not_pinned(empty):
    enc = api.UhdrEncoder(device="cpu")
    enc.set_raw_image(testing.photo_p010(128, 96), ImgLabel.HDR)
    dec = api.UhdrDecoder(device="cpu")
    dec.set_image(enc.encode())
    dec.set_out_color_transfer(CT.HLG)
    dec.set_out_img_format(ImgFmt.RGBA1010102)
    with traced():
        dec.decode()
    assert downloads() == [("output", False), ("map", False)]


def test_the_count_takes_up_to_the_cap_and_gives_back(monkeypatch):
    monkeypatch.setattr(jpegr, "PINNED_CAP_BYTES", 100)
    count = jpegr._PinnedResults()
    assert count.take(60) and count.take(40)
    assert not count.take(1) and count.live == 100
    count.give(40)
    assert not count.take(41) and count.take(40)
    count.give(100)
    assert count.live == 0
    monkeypatch.setattr(jpegr, "PINNED_CAP_BYTES", 0)
    assert not count.take(1) and count.take(0)


def test_the_count_under_contending_threads(monkeypatch):
    """More threads than cores take and give with a short switch interval:
    the count never passes the cap and ends at 0 (a lost update would
    leave it elsewhere)."""
    cap = 64
    monkeypatch.setattr(jpegr, "PINNED_CAP_BYTES", cap)
    count = jpegr._PinnedResults()
    seen, start = [], threading.Barrier(32)

    def worker(seed):
        rs = random.Random(seed)
        start.wait(timeout=60)
        for _ in range(2000):
            n = rs.randint(1, 16)
            if count.take(n):
                seen.append(count.live)
                count.give(n)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert seen and max(seen) <= cap
    assert count.live == 0


class _Event:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def cpu_pinned(monkeypatch):
    """``_pinned_copy`` run on CPU tensors: the block unpinned, the event a
    no-op; a fresh count."""
    empty_like = torch.empty_like

    def unpinned(t, **kw):
        kw.pop("pin_memory")
        return empty_like(t, **kw)

    monkeypatch.setattr(torch, "empty_like", unpinned)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(jpegr, "_PINNED", jpegr._PinnedResults())
    return jpegr._PINNED


def test_bytes_count_until_the_last_view_is_collected(cpu_pinned):
    t = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    out = jpegr._pinned_copy(t)
    assert np.array_equal(out, t.numpy()) and out.dtype == np.int32
    assert cpu_pinned.live == t.nbytes
    view = out.view(np.uint32)[1:, ..., None][..., 0]
    del out
    gc.collect()
    assert cpu_pinned.live == t.nbytes
    assert view[0, 0] == 6
    del view
    gc.collect()
    assert cpu_pinned.live == 0


def test_a_copy_past_the_cap_is_refused(cpu_pinned, monkeypatch):
    t = torch.zeros(4, 4, dtype=torch.uint8)
    monkeypatch.setattr(jpegr, "PINNED_CAP_BYTES", 40)
    first = jpegr._pinned_copy(t)
    assert first is not None and cpu_pinned.live == 16
    second = jpegr._pinned_copy(t)
    assert second is not None and cpu_pinned.live == 32
    assert jpegr._pinned_copy(t) is None and cpu_pinned.live == 32
    del first
    gc.collect()
    assert jpegr._pinned_copy(t) is not None


# ---------------------------------------------------------------------------
# the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.strides == b.strides and np.array_equal(a, b))


def is_pinned(a) -> bool:
    return torch.from_numpy(np.asarray(a)).is_pinned()


@pytest.mark.card
@pytest.mark.parametrize("shape,dtype,layout", [
    ((3072, 4080), torch.int32, "contiguous"),
    ((3072, 4080, 4), torch.int16, "contiguous"),
    ((768, 1020, 3), torch.uint8, "contiguous"),
    ((768, 1020, 1), torch.uint8, "contiguous"),
    ((3, 768, 1020), torch.uint8, "permuted"),
    ((64, 96), torch.int32, "sliced")])
def test_card_download_equals_cpu(card, shape, dtype, layout, empty):
    """The pinned download of a card tensor against ``t.cpu().numpy()``:
    bytes, dtype, shape and strides; the result in pinned memory."""
    g = torch.Generator(device=card).manual_seed(25)
    t = torch.randint(-100, 100, shape, generator=g, device=card).to(dtype)
    if layout == "permuted":
        t = t.permute(1, 2, 0)
    elif layout == "sliced":
        t = t[:, 1::3]
    with traced():
        got = jpegr._download(t, "output")
    assert same_array(got, t.cpu().numpy()) and is_pinned(got)
    assert downloads() == [("output", True)]


DECODES = [(ct, mc) for ct in (CT.HLG, CT.PQ, CT.LINEAR)
           for mc in (False, True)]


@pytest.fixture(scope="module")
def files():
    """Card encodes of a 1024x768 photo with a 1- and a 3-channel map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for mc in (False, True):
        enc = api.UhdrEncoder(device="cuda")
        enc.set_raw_image(testing.photo_p010(1024, 768), ImgLabel.HDR)
        enc.set_using_multi_channel_gainmap(mc)
        out[mc] = enc.encode()
    return out


def decode(data, ct, device="cuda"):
    dest, _, gm = JpegR(device=device).decode(data, ct, return_gainmap=True)
    return dest.planes[0], gm.planes[0]


@pytest.mark.card
@pytest.mark.parametrize("ct,mc", DECODES,
                         ids=[f"{ct.name}-{3 if mc else 1}ch"
                              for ct, mc in DECODES])
def test_card_decode_pinned_equals_pageable(card, files, ct, mc,
                                            monkeypatch, empty):
    """HLG and PQ RGBA1010102, LINEAR RGBAF16, 1- and 3-channel maps: the
    pinned output and map (``pinned`` true on both spans) equal the
    pageable ones, taken with the cap at 0, in bytes, dtype, shape and
    strides; the live count returns once both are dropped."""
    before = jpegr._PINNED.live
    with traced():
        out, gm = decode(files[mc], ct)
    assert downloads() == [("output", True), ("map", True)]
    assert is_pinned(out) and is_pinned(gm)
    assert jpegr._PINNED.live == before + out.nbytes + gm.size  # u8 map
    profiling.clear()
    monkeypatch.setattr(jpegr, "PINNED_CAP_BYTES", 0)
    with traced():
        ref_out, ref_gm = decode(files[mc], ct)
    assert downloads() == [("output", False), ("map", False)]
    assert not is_pinned(ref_out) and not is_pinned(ref_gm)
    assert same_array(out, ref_out) and same_array(gm, ref_gm)
    del out, gm
    gc.collect()
    assert jpegr._PINNED.live == before


def faulty_golden() -> tuple[bytes, bytes]:
    """A reference golden (no DRI: the base's scan goes to the card) and
    the same file with 16 bytes of the base's scan replaced by stuffed FF
    bytes, so the card's decode sets its status word; the length, and with
    it the container's offsets, unchanged."""
    data = bytes(testing.load_golden(testing.golden_names()[0])[0]["jpegr"])
    primary, _ = JpegR.extract_primary_and_gainmap(data)
    at = data.find(primary)
    off = parse_jpeg(primary).scan_offset
    mid = at + off + (len(primary) - off) // 2
    return data, data[:mid] + b"\xff\x00" * 8 + data[mid + 16:]


@pytest.mark.card
def test_card_faulty_scan_takes_the_host_route(card, monkeypatch, empty):
    """A nonzero status word, read after the pinned download of the output,
    discards it: the request is decoded again on the host, through the
    pinned download, and equals the host route's output and map."""
    _, bad = faulty_golden()
    redecodes = hk.HUFFMAN_KERNEL.host_redecodes
    with traced():
        out, gm = decode(bad, CT.HLG)
    assert hk.HUFFMAN_KERNEL.host_redecodes == redecodes + 1
    assert downloads() == [("output", True)] * 2 + [("map", True)]
    monkeypatch.setattr(fused, "card_scan_plan", lambda info, dev: None)
    ref_out, ref_gm = decode(bad, CT.HLG)
    assert same_array(out, ref_out) and same_array(gm, ref_gm)


@pytest.mark.card
def test_card_four_threads_get_their_own_outputs(card):
    """Four threads decode four files at once, a short switch interval:
    each result equals the file's one-thread decode, and every byte counted
    is given back once the results are dropped."""
    names = testing.golden_names()[:4]
    data = [bytes(testing.load_golden(n)[0]["jpegr"]) for n in names]
    before = jpegr._PINNED.live
    want = [decode(d, CT.PQ) for d in data]
    got, start = {}, threading.Barrier(4)

    def client(i):
        start.wait(timeout=60)
        got[i] = [decode(data[i], CT.PQ) for _ in range(6)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    for i in range(4):
        assert len(got[i]) == 6
        for out, gm in got[i]:
            assert same_array(out, want[i][0]) and same_array(gm, want[i][1])
            assert is_pinned(out) and is_pinned(gm)
    del got, want, out, gm
    gc.collect()
    assert jpegr._PINNED.live == before
