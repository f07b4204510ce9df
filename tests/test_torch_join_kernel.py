"""The restart-row join of a fused encode on the device
(``jpeg/join_kernel``): its plain version byte for byte
``native.join_blocks`` on edge cases and on the pack's output of small
API-0 and API-1 encodes, the dispatcher's choice, and the fused encode's
files equal to those of the host join.  On the card (``card`` tests,
skipped without one; run there with ``python -m pytest --noconftest -q
tests/test_torch_join_kernel.py -m card``) the kernel against both, at the
benchmark encode cells' sizes too, and its launches on the encode path.
Imports nothing of JAX."""

import numpy as np
import pytest
import torch

from libultrahdr_tpu_torch import api, errors, fused, testing
from libultrahdr_tpu_torch.jpeg import join_kernel as jk
from libultrahdr_tpu_torch.jpeg import pack_kernel as pk
from libultrahdr_tpu_torch.testing import host_join
from libultrahdr_tpu_torch.types import ColorTransfer, EncPreset, ImgLabel


def joined(words: np.ndarray, blen: np.ndarray, parts, dev="cpu"):
    """Each scan's bytes through the dispatcher on `dev`."""
    out, sizes = jk.join_scans(
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.from_numpy(blen.astype(np.int32)).to(dev), parts)
    sizes = sizes.tolist()
    return jk.scan_bytes(out[:sum(sizes)].cpu().numpy(), sizes)


EDGE = {name: (words, blen, parts)
        for name, words, blen, parts in testing.join_edge_cases()}


@pytest.mark.parametrize("name", sorted(EDGE))
def test_plain_equals_host_join(name):
    words, blen, parts = EDGE[name]
    assert joined(words, blen, parts) == host_join(words, blen, parts)


def test_edge_cases_cover_what_they_name():
    words, blen, parts = EDGE["pad bytes 0xFF"]
    assert host_join(words, blen, parts)[0].count(b"\xff\x00") > 12
    words, blen, parts = EDGE["all ones"]
    scan = host_join(words, blen, parts)[0]
    assert scan.count(b"\xff\x00") >= int(blen.sum()) // 8 - 6
    blen = EDGE["multiples of 8 and 32"][1]
    assert (blen % 32 == 0).any() and (blen % 8 == 0).all()
    assert (EDGE["empty blocks"][1] == 0).any()
    assert len(EDGE["two scans"][2]) == 2
    words, blen, parts = EDGE["19 rows of markers"]
    scan = host_join(words, blen, parts)[0]
    assert all(bytes([0xFF, 0xD0 + k]) in scan for k in range(8))


@pytest.mark.parametrize("seed", range(6))
def test_plain_equals_host_join_random(seed):
    """Random scans back to back: one to three parts, 1-9 blocks a row."""
    rs = np.random.RandomState(seed)
    parts = [(b * rs.randint(1, 7), b) for b in
             rs.randint(1, 10, rs.randint(1, 4))]
    n = sum(nb for nb, _ in parts)
    blen = rs.randint(1, 1985 if seed % 2 else 80, n)
    words = testing.join_words(blen, rs, 0xFFFFFFFF if seed == 5 else None)
    assert joined(words, blen, parts) == host_join(words, blen, parts)


def encoder(api1: bool, multichannel: bool, w=96, h=64):
    img = testing.photo_p010(w, h)
    img.ct = ColorTransfer.HLG
    enc = api.UhdrEncoder(device="cpu")
    enc.set_raw_image(img, ImgLabel.HDR)
    if api1:
        enc.set_raw_image(api.JpegR(device="cpu").tone_map(img),
                          ImgLabel.SDR)
        enc.set_preset(EncPreset.BEST_QUALITY)
    enc.set_gainmap_scale_factor(1 if multichannel else 4)
    enc.set_using_multi_channel_gainmap(multichannel)
    return enc


ENCODES = {"api0_1ch": (False, False), "api0_3ch": (False, True),
           "api1_1ch": (True, False), "api1_3ch": (True, True)}


@pytest.mark.parametrize("which", sorted(ENCODES))
def test_plain_equals_host_join_on_the_pack(which, monkeypatch):
    """The pack's output of a small fused encode (both scans back to back):
    the plain join == ``native.join_blocks`` on each scan, and those are
    the file's scans."""
    seen = []
    orig = fused._pack_scans

    def keep(scans, pack):
        out = orig(scans, pack)
        seen.append((out, [lay for _, lay in scans]))
        return out
    monkeypatch.setattr(fused, "_pack_scans", keep)
    data = encoder(*ENCODES[which]).encode()
    ((words, blen), layouts), = seen
    parts = [(lay.mcus_h * lay.bpr, lay.bpr) for lay in layouts]
    w, b = words.numpy().view(np.uint32), blen.numpy()
    want = host_join(w, b, parts)
    assert joined(w, b, parts) == want
    primary, gm_jpeg, _ = testing.read_jpegr(data)
    assert [testing.scan_data(primary), testing.scan_data(gm_jpeg)] == want


@pytest.mark.parametrize("which", sorted(ENCODES))
def test_fused_encode_bytes_equal_host_join(which, monkeypatch):
    """The fused route's file is the file that the host join gives on the
    same words: the device join changes no byte."""
    got = encoder(*ENCODES[which]).encode()

    def host_route(words, blen, parts):
        scans = host_join(words.numpy().view(np.uint32), blen.numpy(),
                          parts)
        out = bytearray(b"".join(scans))
        return (torch.frombuffer(out, dtype=torch.uint8),
                torch.tensor([len(s) for s in scans]))
    monkeypatch.setattr(jk, "join_scans", host_route)
    assert encoder(*ENCODES[which]).encode() == got


def test_dispatcher_routes_by_device(monkeypatch):
    words, blen, parts = EDGE["two scans"]
    w = torch.from_numpy(words.view(np.int32))
    b = torch.from_numpy(blen.astype(np.int32))
    calls = []
    monkeypatch.setattr(jk, "join_scans_plain",
                        lambda *a: calls.append(a) or "plain")
    assert jk.join_scans(w, b, parts) == "plain" and len(calls) == 1
    with pytest.raises(errors.UhdrError):
        jk.join_scans(w.to("meta"), b.to("meta"), parts)
    launches = jk.JOIN_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        jk.JOIN_KERNEL(w, b, parts)
    assert jk.JOIN_KERNEL.launches == launches


def test_parts_must_cover_whole_rows():
    words, blen, _ = EDGE["a single row"]
    w = torch.from_numpy(words.view(np.int32))
    b = torch.from_numpy(blen.astype(np.int32))
    for parts in ([(13, 5)], [(12, 12)], [], [(13, 0)]):
        with pytest.raises(ValueError):
            jk.join_scans_plain(w, b, parts)


def test_card_share_reader():
    """``encode_join.card_share_pct`` (the benchmark's reader): the share of
    the window's ``encode.join`` spans whose engine is the device; nothing
    where no span carries an engine (the port before the device join)."""
    from libultrahdr_tpu_torch.utils import profiling
    from uhdrbench import harness, trace
    t0 = 1_790_000_000
    read = harness.metric_reader("encode_join.card_share_pct")
    tr = trace.Trace([], [], (t0, t0 + 1.0), [(0.0, 0.1, 1.0)], [], {}, {})

    def put(i, start, **attrs):
        ns = t0 * 10 ** 9 + round(start * 1e9)
        profiling._record(profiling.Span("encode.join", ns, ns + 10 ** 6, 0,
                                         i, None, 1, 1, attrs))
    profiling.clear()
    try:
        assert read(tr) is None
        put(1, 0.1, bytes=10)
        assert read(tr) is None
        put(2, 0.2, engine="device")
        put(3, 0.3, engine="device")
        put(4, 0.4, engine="host", bytes=5)
        put(5, -1.0, engine="host")                # before the window
        assert read(tr) == pytest.approx(200.0 / 3.0)
    finally:
        profiling.clear()


# ---------------------------------------------------------------------------
# the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(EDGE))
def test_card_kernel_equals_plain_and_host(card, name):
    words, blen, parts = EDGE[name]
    before = jk.JOIN_KERNEL.launches
    got = joined(words, blen, parts, card)
    assert jk.JOIN_KERNEL.launches == before + 1
    assert got == joined(words, blen, parts) == host_join(words, blen, parts)


CELLS = {"android_12mp": (4080, 3072, ColorTransfer.HLG, 4, False),
         "libdefault_8k": (8192, 4320, ColorTransfer.PQ, 1, True)}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_card_kernel_on_the_cells_scans(card, cell, monkeypatch):
    """A benchmark encode cell's request through ``UhdrEncoder`` on the
    card: one join launch, and on the same pack output the kernel == the
    plain version on the card's tensors == ``native.join_blocks``."""
    w, h, ct, scale, multichannel = CELLS[cell]
    img = testing.photo_p010(w, h)
    img.ct = ct
    enc = api.UhdrEncoder(device="cuda")
    enc.set_raw_image(img, ImgLabel.HDR)
    enc.set_gainmap_scale_factor(scale)
    enc.set_using_multi_channel_gainmap(multichannel)
    seen = []
    orig = fused._pack_scans

    def keep(scans, pack):
        out = orig(scans, pack)
        seen.append((out, [lay for _, lay in scans]))
        return out
    monkeypatch.setattr(fused, "_pack_scans", keep)
    before = jk.JOIN_KERNEL.launches
    data = enc.encode()
    assert jk.JOIN_KERNEL.launches == before + 1
    ((room, blen), layouts), = seen
    parts = [(lay.mcus_h * lay.bpr, lay.bpr) for lay in layouts]
    total = int(((blen.long() + 31) >> 5).sum())
    words = room[:total].cpu().numpy().view(np.uint32)
    b = blen.cpu().numpy()
    want = host_join(words, b, parts)
    primary, gm_jpeg, _ = testing.read_jpegr(data)
    assert [testing.scan_data(primary), testing.scan_data(gm_jpeg)] == want
    out, sizes = jk.join_scans_plain(room[:total], blen, parts)
    assert jk.scan_bytes(out.cpu().numpy(), sizes.tolist()) == want
    assert joined(words, b, parts, card) == want
    assert room.numel() == blen.numel() * pk.CAP_WORDS
