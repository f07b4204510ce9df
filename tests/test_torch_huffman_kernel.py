"""The entropy decoder of baseline scans without restart markers
(``jpeg/huffman_kernel``): on the CPU its plain version against the host's
``native.decode_scan`` bit for bit, the faults it refuses and the route's
choice of scans; on the card (``card`` tests, skipped without one; run
``python -m pytest --noconftest -q tests/test_torch_huffman_kernel.py -m
card``) the kernel against both, at the benchmark's 12 MP files too, and
the fused decode with it against the host route.  Imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from libultrahdr_tpu_torch import fused, testing
from libultrahdr_tpu_torch.jpeg import huffman_kernel as hk, native
from libultrahdr_tpu_torch.jpeg.decoder import parse_jpeg
from libultrahdr_tpu_torch.jpegr import JpegR

EDGE = testing.huffman_edge_cases()
FAULTS = testing.huffman_fault_cases()


def _goldens():
    """(name, JPEG) of the base and the gain map of each reference golden
    (none carries a DRI)."""
    out = []
    for name in testing.golden_names():
        primary, gm = JpegR.extract_primary_and_gainmap(
            bytes(testing.load_golden(name)[0]["jpegr"]))
        out += [(f"{name} base", primary), (f"{name} map", gm)]
    return out


GOLDENS = _goldens()
CASES = [(name, data, bits) for name, data, bits in EDGE] \
    + [(name, data, 64) for name, data in GOLDENS]


def host_planes(data: bytes, info) -> list[np.ndarray]:
    comps = [{"h": c.h, "v": c.v, "dc_tbl": c.dc_tbl, "ac_tbl": c.ac_tbl}
             for c in info.components]
    plan = hk.scan_plan(info)
    return native.decode_scan(
        data[info.scan_offset:], comps, plan.mcus_w, plan.mcus_h,
        [info.dc_tables.get(i) for i in range(4)],
        [info.ac_tables.get(i) for i in range(4)], info.restart_interval)[0]


def decode(data: bytes, sub_bits: int, device="cpu"):
    """(planes, status) of the dispatcher on `device`, and the parse."""
    info = parse_jpeg(data)
    plan = hk.scan_plan(info)
    assert plan is not None
    staged = hk.stage(data, info.scan_offset, plan).to(device)
    planes, status = hk.decode(staged, plan, sub_bits=sub_bits)
    return [p.cpu().numpy() for p in planes], int(status), info


@pytest.mark.parametrize("name,data,sub_bits", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_equals_host_decode(name, data, sub_bits):
    planes, status, info = decode(data, sub_bits)
    want = host_planes(data, info)
    assert status == 0, f"{name}: status {status}"
    assert len(planes) == len(want)
    for got, ref in zip(planes, want):
        assert got.dtype == np.int16 and np.array_equal(got, ref), name


def test_edge_cases_cover_what_they_name():
    """The stuffed scan is dense in FF 00, the subsequences come down to 32
    bits, every sampling and channel count is there, the goldens too."""
    stuffed = dict((n, d) for n, d, _ in EDGE)["dense FF 00 stuffing, "
                                               "32 bits"]
    info = parse_jpeg(stuffed)
    scan = np.frombuffer(stuffed, np.uint8)[info.scan_offset:]
    assert np.mean(scan[:-2] == 0xFF) > 0.15
    assert min(b for *_, b in EDGE) == 32
    kinds = {(len(p.comps), len(p.units)) for p in (
        hk.scan_plan(parse_jpeg(d)) for _, d, _ in EDGE)}
    assert {(3, 6), (3, 3), (1, 1)} <= kinds
    assert len(GOLDENS) == 2 * len(testing.golden_names()) >= 14 and all(
        hk.scan_plan(parse_jpeg(d)) is not None for _, d in GOLDENS)


@pytest.mark.parametrize("name,data", FAULTS, ids=[f[0] for f in FAULTS])
def test_plain_refuses_faults(name, data):
    _, status, _ = decode(data, 64)
    assert status != 0, name


def test_plain_flipped_bytes_refused_or_equal_to_host():
    """Seeded bit flips in a scan: each mutant is refused (a nonzero status)
    or decoded as the host decodes it; some are refused."""
    data = testing.dri_less_jpeg("420", 96, 64, 90)
    off = parse_jpeg(data).scan_offset
    rs = np.random.default_rng(23)
    refused = 0
    for _ in range(8):
        d = bytearray(data)
        for _ in range(int(rs.integers(1, 4))):
            d[int(rs.integers(off, len(d) - 2))] ^= 1 << int(rs.integers(8))
        planes, status, info = decode(bytes(d), 64)
        if status:
            refused += 1
            continue
        assert all(np.array_equal(g, w) for g, w in
                   zip(planes, host_planes(bytes(d), info)))
    assert refused > 0


def test_card_route_takes_only_scans_without_restart_markers(monkeypatch):
    """``fused.card_scan_plan``: a baseline scan without a DRI on a CUDA
    device; not a DRI file (every file the port's encoders write), not a
    progressive one, not the CPU, not with the coefficient wire on, not a
    scan whose table the host refuses."""
    cuda = torch.device("cuda")
    plain = parse_jpeg(EDGE[0][1])
    assert fused.card_scan_plan(plain, cuda) is not None
    assert fused.card_scan_plan(plain, torch.device("cpu")) is None
    assert fused.card_scan_plan(
        dataclasses.replace(plain, restart_interval=4), cuda) is None
    assert fused.card_scan_plan(
        dataclasses.replace(plain, progressive=True), cuda) is None
    port_file = JpegR(device="cpu").encode_api0(
        testing.photo_p010(64, 48), quality=90)
    primary, gm = JpegR.extract_primary_and_gainmap(port_file)
    for jpeg in (primary, gm):
        info = parse_jpeg(jpeg)
        assert info.restart_interval > 0
        assert fused.card_scan_plan(info, cuda) is None
    monkeypatch.setenv("UHDR_TPU_WIRE", "auto")
    assert fused.card_scan_plan(plain, cuda) is None
    monkeypatch.delenv("UHDR_TPU_WIRE")
    bad = dataclasses.replace(plain, ac_tables={
        **plain.ac_tables, 0: type(plain.ac_tables[0])(
            [0, 4] + [0] * 14, [1, 2, 3, 4])})   # 4 codes of 2 bits: all ones
    assert hk.scan_plan(bad) is None


def test_header_layout():
    """The header's words sit where ``csrc/huffman_kernel.cu`` reads them."""
    plan = hk.scan_plan(parse_jpeg(EDGE[0][1]))
    b = hk.header(plan)
    w = b.view(np.int32)
    assert b.size == hk.HEADER_BYTES
    assert list(w[:5]) == [4, 6, 3, plan.mcus_w, plan.mcus_h]
    assert list(w[8:11]) == [2, 1, 1] and list(w[12:15]) == [2, 1, 1]
    assert list(w[16:19]) == [2 * plan.mcus_w, plan.mcus_w, plan.mcus_w]
    assert list(w[32:38]) == [0, 0, 0, 0, 1, 1]        # DC slots
    assert list(w[48:54]) == [2, 2, 2, 2, 3, 3]        # AC slots
    assert list(w[64:70]) == [0, 0, 0, 0, 1, 2]        # components
    assert list(w[80:84]) == [0, 0, 1, 1] and list(w[96:100]) == [0, 1, 0, 1]
    assert list(b[512:528]) == list(plan.slots[0][0])
    assert list(b[640 + 256 * 2:640 + 256 * 2 + 162]) == \
        list(plan.slots[2][1])


# ---------------------------------------------------------------------------
# the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name,data,sub_bits", CASES,
                         ids=[c[0] for c in CASES])
def test_card_kernel_equals_plain_and_host(card, name, data, sub_bits):
    before = hk.HUFFMAN_KERNEL.launches
    got, status, info = decode(data, sub_bits, card)
    plain, plain_status, _ = decode(data, sub_bits)
    assert hk.HUFFMAN_KERNEL.launches == before + 1
    assert status == plain_status == 0, name
    for g, p, h in zip(got, plain, host_planes(data, info)):
        assert np.array_equal(g, p) and np.array_equal(g, h), name


@pytest.mark.card
@pytest.mark.parametrize("name,data", FAULTS, ids=[f[0] for f in FAULTS])
def test_card_kernel_refuses_faults(card, name, data):
    _, status, _ = decode(data, 64, card)
    _, plain_status, _ = decode(data, 64)
    assert status != 0 and status == plain_status, name


def bench_file(cell: str) -> bytes:
    """One of the benchmark's 12 MP decode files (the plain writer's, no
    DRI)."""
    from uhdrbench import harness
    c, cfg = harness.load_cell(cell)
    return harness.make_inputs(dict(c, pool=1), cfg, 2 ** 31 + 11,
                               "cuda")[0]


CELLS = ["android_12mp.decode_hlg_c1", "libdefault_12mp.decode_pq_c4"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_kernel_on_the_benchmark_files(card, cell):
    """The base and the map of a 12 MP file: kernel == host, and == the
    plain version run on the card's tensors."""
    for jpeg in JpegR.extract_primary_and_gainmap(bench_file(cell)):
        got, status, info = decode(jpeg, hk.SUB_BITS, card)
        assert status == 0
        for g, h in zip(got, host_planes(jpeg, info)):
            assert np.array_equal(g, h)
        plan = hk.scan_plan(info)
        staged = hk.stage(jpeg, info.scan_offset, plan).to(card)
        planes, st = hk.decode_plain(staged, plan)
        assert int(st) == 0
        assert all(torch.equal(p.cpu(), torch.from_numpy(g))
                   for p, g in zip(planes, got))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_decode_equals_host_route(card, cell, monkeypatch):
    """``UhdrDecoder.decode`` of a 12 MP file: two kernel launches, no
    re-decode, and the output and map bit for bit the host route's."""
    from libultrahdr_tpu_torch import api
    from libultrahdr_tpu_torch.types import ColorTransfer, ImgFmt
    data = bench_file(cell)

    def run():
        dec = api.UhdrDecoder(device="cuda")
        dec.set_image(data)
        dec.set_out_color_transfer(ColorTransfer.HLG)
        dec.set_out_img_format(ImgFmt.RGBA1010102)
        img = dec.decode()
        return img.planes[0], dec.get_decoded_gainmap_image().planes[0]

    launches, redecodes = hk.HUFFMAN_KERNEL.launches, \
        hk.HUFFMAN_KERNEL.host_redecodes
    out, gm = run()
    assert hk.HUFFMAN_KERNEL.launches == launches + 2
    assert hk.HUFFMAN_KERNEL.host_redecodes == redecodes
    monkeypatch.setattr(fused, "card_scan_plan", lambda info, dev: None)
    ref_out, ref_gm = run()
    assert hk.HUFFMAN_KERNEL.launches == launches + 2
    assert np.array_equal(np.asarray(out), np.asarray(ref_out))
    assert np.array_equal(np.asarray(gm), np.asarray(ref_gm))


def test_card_share_reader():
    """``huffman.card_share_pct`` (the benchmark's reader): the share of the
    window's ``decode.huffman`` spans whose engine is the card; nothing
    where no span carries an engine (the port before the card decoder)."""
    from libultrahdr_tpu_torch.utils import profiling
    from uhdrbench import harness, trace
    t0 = 1_790_000_000
    read = harness.metric_reader("huffman.card_share_pct")
    tr = trace.Trace([], [], (t0, t0 + 1.0), [(0.0, 0.1, 1.0)], [], {}, {})

    def put(i, start, **attrs):
        ns = t0 * 10 ** 9 + round(start * 1e9)
        profiling._record(profiling.Span(
            "decode.huffman", ns, ns + 10 ** 6, 0, i, None, i, 1, attrs))

    profiling.clear()
    try:
        assert read(tr) is None
        put(1, 0.1, image="base")
        assert read(tr) is None
        for i, engine in enumerate(("device", "device", "host", "device")):
            put(2 + i, 0.2 + 0.1 * i, image="base", engine=engine)
        put(9, -1.0, image="base", engine="host")   # before the window
        assert read(tr) == pytest.approx(75.0)
    finally:
        profiling.clear()


def test_dispatch_lock_keeps_concurrent_dispatches_apart(monkeypatch):
    """Decodes from more threads than cores, with a short switch interval:
    no two dispatches onto one device overlap (``fused.dispatch_lock``),
    and every output equals the one-thread decode."""
    import os
    import sys
    import threading
    data = JpegR(device="cpu").encode_api0(testing.photo_p010(64, 48),
                                           quality=90)
    want = np.asarray(JpegR(device="cpu").decode(data)[0].planes[0])
    inside, worst = [0], [0]
    guard = threading.Lock()
    core = fused._decode_sdr_and_gain

    def counting(*args, **kwargs):
        with guard:
            inside[0] += 1
            worst[0] = max(worst[0], inside[0])
        try:
            return core(*args, **kwargs)
        finally:
            with guard:
                inside[0] -= 1

    monkeypatch.setattr(fused, "_decode_sdr_and_gain", counting)
    n = min(16, (os.cpu_count() or 2) + 2)
    outs = [None] * n

    def run(i):
        outs[i] = np.asarray(JpegR(device="cpu").decode(data)[0].planes[0])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert worst[0] == 1
    assert all(o is not None and np.array_equal(o, want) for o in outs)
