"""The plain writer's files are shaped like a phone's: baseline, no DRI,
Annex K tables, MPF with XMP or ISO metadata; the port's decoder takes
them on its fused route; the plain Huffman decoder reads back what the
writer coded."""

import numpy as np
import pytest
import torch

from uhdrbench import harness, scene
from uhdrbench.reference import codec, container, jpeg

SIZE = (128, 96)


def _file(cell_name, seed=5):
    cell, cfg = harness.load_cell(cell_name)
    cfg = dict(cfg, width=SIZE[0], height=SIZE[1])
    y, uv = scene.pool(*SIZE, 1, seed)[0]
    yt, uvt = (torch.from_numpy(p.view(np.int16)) for p in (y, uv))
    xmp = cfg["metadata"] == "XMP"
    exp = codec.encode_expectation(cfg, yt, uvt, xmp=xmp)
    return cfg, exp, codec.write_file(cfg, exp, xmp), xmp


@pytest.mark.parametrize("cell", ["android_12mp.decode_hlg_c1",
                                  "libdefault_12mp.decode_pq_c4"])
def test_writer_file_is_phone_shaped(cell):
    cfg, exp, data, xmp = _file(cell)
    primary, gm = container.split(data)
    pb, pg = jpeg.parse_jpeg(primary), jpeg.parse_jpeg(gm)
    assert pb.sof == pg.sof == 0xC0
    assert pb.dri == pg.dri == 0
    assert b"\xff\xdd" not in primary and b"\xff\xdd" not in gm
    assert [(c[1], c[2]) for c in pb.comps] == [(2, 2), (1, 1), (1, 1)]
    assert len(pg.comps) == (3 if cfg["multichannel_map"] else 1)
    assert all((c[1], c[2]) == (1, 1) for c in pg.comps)
    assert (pg.w, pg.h) == (SIZE[0] // cfg["map_scale"],
                            SIZE[1] // cfg["map_scale"])
    assert pb.huff[(0, 0)] == (jpeg.DC_LUMA[0], jpeg.DC_LUMA[1])
    meta = container.gainmap_metadata(pg.app)
    assert any(m == 0xE1 for m, _ in pg.app) == xmp
    assert meta["use_base_cg"] == exp["use_base_cg"]
    # the coefficients read back are the ones written
    got = jpeg.huffman_decode([pb, pg])
    for part, planes in (("base", got[0]), ("map", got[1])):
        for g, w in zip(planes, exp[part]):
            assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("cell", ["android_12mp.decode_hlg_c1",
                                  "libdefault_12mp.decode_pq_c4"])
def test_port_takes_the_fused_route(cell):
    from libultrahdr_tpu_torch.jpegr import JpegR
    from libultrahdr_tpu_torch.jpeg.decoder import parse_jpeg
    from libultrahdr_tpu_torch.types import ColorTransfer
    cfg, exp, data, xmp = _file(cell)
    jr = JpegR(device="cpu")
    prim, pinfo, gm, ginfo, meta, sdr_cg, gm_cg = jr._parse_jpegr(data)
    plan = jr._fused_plan(pinfo, ginfo, meta, sdr_cg, gm_cg,
                          ColorTransfer[harness.load_cell(cell)[0]
                                        ["out_transfer"]])
    assert plan is not None
    assert plan["scale_k"] == cfg["map_scale"]
    assert plan["gm_channels"] == (3 if cfg["multichannel_map"] else 1)
    assert plan["use_base_cg"] == exp["use_base_cg"]
    assert parse_jpeg(prim, parse_only=True).progressive is False


def test_decoder_reads_restart_intervals():
    """A stream with one restart interval a row decodes lane by lane to
    the same coefficients as the port's host decoder."""
    cell, cfg = harness.load_cell("android_12mp.encode_c4")
    cfg = dict(cfg, width=SIZE[0], height=SIZE[1])
    y, uv = scene.pool(*SIZE, 1, 9)[0]
    data = harness.Port("cpu").encode(cfg, (y, uv))
    primary, gm = container.split(data)
    pb = jpeg.parse_jpeg(primary)
    assert pb.dri > 0
    got = jpeg.huffman_decode([pb])[0]
    from libultrahdr_tpu_torch import fused
    from libultrahdr_tpu_torch.jpeg.decoder import parse_jpeg
    want = fused.decode_coefficients(primary, parse_jpeg(primary))[0]
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w).astype(np.int64))


def test_decoder_reports_bad_data():
    cfg, exp, data, xmp = _file("android_12mp.decode_hlg_c1")
    primary, _ = container.split(data)
    pb = jpeg.parse_jpeg(primary)
    pb.data = pb.data[: len(pb.data) // 2]
    assert isinstance(jpeg.huffman_decode([pb])[0], str)
