"""PyTorch port: the general decode path against the JAX package.

The streams are made here from JAX-written API-0 files of
``benchmarks.photo_p010`` at 136x72 and fed, byte for byte, to the JAX
``JpegR().decode`` (CPU, plain XLA apply) and to
``port.JpegR(device="cpu")`` / ``port.UhdrDecoder(device="cpu")``:

- ``idw_upsample_fractional`` on seeded maps at several factors: within 4
  float32 ulps of the JAX function (XLA's CPU fusion contracts products and
  sums into FMAs, eager PyTorch does not), at most 2.4e-7 apart;
- progressive streams written by PIL (4:2:0, 4:4:4, grayscale, a restart
  interval; every PIL progressive file refines by successive
  approximation): the coefficients and the planes bit-exact;
- each kind of stream that only the general path takes (a fractional map
  scale with 1 and 3 channels, a map resized for its aspect ratio, a
  grayscale base, a progressive base, a progressive map with 1 and 3
  channels, a 3-channel map with subsampled chroma) and ``use_fused=False``
  on each sampling that both packages' general path takes, to HLG, PQ and
  LINEAR: outputs within ``testing.check_decoded_close``, the returned
  gain-map images and the metadata equal;
- SRGB of a progressive file byte for byte; the refusals (4:4:0 with
  ``use_fused=False``, 4:1:1 and 4:1:0 to HDR, ``decode_to_device`` of a
  general-path stream) with the JAX error codes;
- ``UHDR_TPU_DECODE_ENGINE`` general / auto / device through
  ``UhdrDecoder`` (the host engine: tests/test_torch_decode_host.py);
- the committed 4K fixture ``tests/data/progressive_jpegr_3840x2160.jpg``.
"""

import functools
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import benchmarks
from libultrahdr_tpu import api as jax_api
from libultrahdr_tpu import errors as jax_errors
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.jpeg import decoder as jax_decoder
from libultrahdr_tpu.ops import idw as jax_idw

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.container import icc as port_icc
from libultrahdr_tpu_torch.jpeg import decoder as port_decoder
from libultrahdr_tpu_torch.jpeg.encoder import JpegEncoder
from libultrahdr_tpu_torch.ops import idw as port_idw

Image = pytest.importorskip("PIL.Image")

W, H = 136, 72
CPU = torch.device("cpu")
Fmt, CG, CT = port.ImgFmt, port.ColorGamut, port.ColorTransfer
OUTS = ("HLG", "PQ", "LINEAR")
JAX_OUT_FMT = {"HLG": jax_types.ImgFmt.RGBA1010102,
               "PQ": jax_types.ImgFmt.RGBA1010102,
               "LINEAR": jax_types.ImgFmt.RGBAF16}


# ---------------------------------------------------------------------------
# the fractional IDW


@pytest.mark.parametrize("c,mh,mw,oh,ow", [
    (1, 7, 11, 50, 77),          # 7.0 on x, 7.14 on y
    (3, 9, 13, 64, 91),
    (3, 77, 137, 540, 960),      # the 4K map at scale 7, quartered: 7.007
    (1, 5, 5, 23, 23),           # 4.6
    (1, 24, 45, 72, 136),        # the test streams' fractional map: 3.02
])
def test_idw_upsample_fractional_matches_jax(c, mh, mw, oh, ow):
    g = np.random.RandomState(mh * mw).randint(
        0, 256, (c, mh, mw)).astype(np.float32) / 255.0
    scale = ow / mw
    want = np.asarray(jax_idw.idw_upsample_fractional(jnp.asarray(g), scale,
                                                      oh, ow))
    got = port_idw.idw_upsample_fractional(torch.from_numpy(g), scale, oh,
                                           ow).numpy()
    assert got.shape == want.shape == (c, oh, ow)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4
    assert np.abs(got - want).max() <= 2.4e-7
    # texels hit exactly are returned as they are
    np.testing.assert_array_equal(got[:, 0, 0], g[:, 0, 0])


# ---------------------------------------------------------------------------
# progressive streams: coefficients and planes bit-exact


def _scene_rgb(w, h, seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(xx / 23.0) * np.cos(yy / 17.0)
    tex = np.kron(rs.randn(h // 4 + 1, w // 4 + 1),
                  np.ones((4, 4)))[:h, :w] * 0.05
    r = np.clip(base + tex, 0, 1)
    g = np.clip(0.8 - 0.5 * base + tex, 0, 1)
    b = np.clip(0.3 + 0.6 * np.cos(xx / 31.0), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def _pil_jpeg(arr, mode="RGB", **save_kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **save_kw)
    return buf.getvalue()


PROGRESSIVE = {
    "420": lambda: _pil_jpeg(_scene_rgb(200, 120), progressive=True,
                             quality=85, subsampling=2),
    "444": lambda: _pil_jpeg(_scene_rgb(96, 64, 3), progressive=True,
                             quality=90, subsampling=0),
    "gray": lambda: _pil_jpeg(_scene_rgb(128, 80, 5)[..., 0], "L",
                              progressive=True, quality=80),
    "restart": lambda: _pil_jpeg(_scene_rgb(160, 96, 7), progressive=True,
                                 quality=88, subsampling=2,
                                 restart_marker_rows=2),
    "odd 4:2:0": lambda: _pil_jpeg(_scene_rgb(129, 67, 9), progressive=True,
                                   quality=95, subsampling=2),
}


@pytest.mark.parametrize("kind", PROGRESSIVE)
def test_progressive_coefficients_and_planes_bit_exact(kind):
    data = PROGRESSIVE[kind]()
    info = port_decoder.parse_jpeg(data)
    jinfo = jax_decoder.parse_jpeg(data)
    assert info.progressive and len(info.scans) == len(jinfo.scans) > 1
    # successive approximation: refinement scans (Ah > 0)
    assert any(s["ah"] for s in info.scans)
    if kind == "restart":
        assert any(s["restart_interval"] for s in info.scans)
    coeffs, qts, fmt = port_decoder.decode_coefficients(data, info)
    hmax = max(c.h for c in jinfo.components)
    vmax = max(c.v for c in jinfo.components)
    comps = [{"h": c.h, "v": c.v, "dc_tbl": c.dc_tbl, "ac_tbl": c.ac_tbl}
             for c in jinfo.components]
    want = jax_decoder._decode_progressive_coeffs(
        data, jinfo, comps, -(-jinfo.width // (8 * hmax)),
        -(-jinfo.height // (8 * vmax)), hmax, vmax)
    assert len(coeffs) == len(want) == info.num_components
    for a, b in zip(coeffs, want):
        assert a.dtype == np.int16 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
    planes, pfmt = port_decoder.decode_to_planes(data, None, device=CPU)
    jplanes, jfmt = jax_decoder.decode_to_planes(data)
    assert int(pfmt) == int(jfmt) == int(fmt)
    for a, b in zip(planes, jplanes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_progressive_scan_needs_only_the_tables_it_uses():
    """A DC refinement scan reads no table, so it decodes without one; an
    AC scan whose table is missing raises the JAX package's codec error."""
    data = PROGRESSIVE["444"]()
    want, _ = jax_decoder.decode_to_planes(data)
    codes = []
    for parse, decode in (
            (port_decoder.parse_jpeg,
             lambda info: port_decoder.decode_to_planes(data, info,
                                                        device=CPU)),
            (jax_decoder.parse_jpeg,
             lambda info: jax_decoder.decode_to_planes(data, info))):
        info = parse(data)
        refine = [s for s in info.scans if s["ss"] == 0 and s["ah"] > 0]
        assert refine
        for s in refine:
            s["dc_tables"] = {}
        for a, b in zip(decode(info)[0], want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        next(s for s in info.scans if s["ss"] > 0)["ac_tables"] = {}
        with pytest.raises((port.UhdrError, jax_errors.UhdrError)) as e:
            decode(info)
        assert "missing AC huffman table" in str(e.value)
        codes.append(int(e.value.code))
    assert codes == [int(port.UhdrErrorCode.UHDR_CODEC_ERROR)] * 2


# ---------------------------------------------------------------------------
# the general path's stream kinds


@functools.lru_cache(maxsize=None)
def _jax_file(scale: int, multichannel: bool) -> bytes:
    return jax_jpegr.JpegR(
        map_dimension_scale_factor=scale,
        use_multi_channel_gainmap=multichannel).encode_api0(
            benchmarks.photo_p010(W, H), 95)


def _split(data: bytes):
    """(base JPEG, gain-map JPEG, metadata) of a JPEG_R file."""
    primary, gm = port.JpegR.extract_primary_and_gainmap(data)
    pinfo, gm_info = port_decoder.parse_jpeg(primary), \
        port_decoder.parse_jpeg(gm)
    md = port.JpegR.parse_gainmap_metadata(gm_info.iso, gm_info.xmp,
                                           pinfo.exif)
    return primary, gm, md


def _api4(base: bytes, gm: bytes, md) -> bytes:
    """A JPEG_R file of a base and a gain-map JPEG (their APPn segments
    but the ICC dropped) and metadata, through the port's API-4."""
    return port.JpegR(device="cpu").encode_api4(
        port.CompressedImage(testing.without_app_segments(base, True),
                             CG.DISPLAY_P3),
        port.CompressedImage(testing.without_app_segments(gm, True)), md)


def _rebased(sampling) -> bytes:
    """The benchmark configuration's file (map scale 4, one channel) with
    its base re-encoded by the port's JpegEncoder at `sampling` (an ImgFmt
    of YUV planes), chroma taken from the base's full-resolution chroma."""
    primary, gm, md = _split(_jax_file(4, False))
    (y, u, v), _ = port_decoder.decode_to_planes(primary, None, device=CPU)
    full = [np.repeat(np.repeat(c.numpy(), 2, 0), 2, 1)[:H, :W]
            for c in (u, v)]
    sub = {Fmt.YUV444: (1, 1), Fmt.YUV422: (2, 1), Fmt.YUV440: (1, 2),
           Fmt.YUV411: (4, 1), Fmt.YUV410: (4, 2)}
    planes = [y.numpy()]
    if sampling in sub:
        hs, vs = sub[sampling]
        planes += [np.ascontiguousarray(c[::vs, ::hs]) for c in full]
    img = port.RawImage(sampling, CG.DISPLAY_P3, CT.SRGB,
                        port.ColorRange.FULL, W, H, planes)
    icc = port_icc.write_icc_profile(CT.SRGB, CG.DISPLAY_P3)
    return _api4(JpegEncoder(CPU).compress(img, 95, icc=icc), gm, md)


def _remapped(multichannel: bool, rgb_fn, **save_kw) -> bytes:
    """A file with its gain map re-encoded by PIL from `rgb_fn` of the
    map's RGB decode ((h, w, 3) u8, or (h, w) for one channel)."""
    primary, gm, md = _split(_jax_file(4, multichannel))
    rgb = port_decoder.decode_to_rgb(gm, None, CPU).permute(1, 2, 0).numpy()
    arr = rgb_fn(rgb if multichannel else rgb[..., 0])
    icc = Image.open(io.BytesIO(gm)).info.get("icc_profile")
    new = _pil_jpeg(np.ascontiguousarray(arr),
                    "RGB" if multichannel else "L", quality=95,
                    icc_profile=icc, **save_kw)
    return _api4(primary, new, md)


STREAMS = {
    # a 45x24 map on 136x72: 3.02 on x, aspect 0.74% off
    "fractional 1-channel": lambda: _jax_file(3, False),
    "fractional 3-channel": lambda: _jax_file(3, True),
    # 34x12: aspect 2.83 against 1.89, resized on the host
    "resized map": lambda: _remapped(False, lambda m: m[:12]),
    "grayscale base": lambda: _rebased(Fmt.YUV400),
    "progressive base": lambda: testing.progressive_jpegr(_jax_file(4, True),
                                                          quality=90),
    "progressive map": lambda: _remapped(False, lambda m: m,
                                         progressive=True),
    "progressive 3-channel map": lambda: _remapped(
        True, lambda m: m, progressive=True, subsampling=0),
    "subsampled 3-channel map": lambda: _remapped(True, lambda m: m,
                                                  subsampling=2),
}
# use_fused=False on the samplings that the general path of both packages
# takes (4:4:0 is refused there, below)
FUSABLE = {
    "4:2:0 use_fused=False": lambda: _jax_file(4, False),
    "4:4:4 use_fused=False": lambda: _rebased(Fmt.YUV444),
    "4:2:2 use_fused=False": lambda: _rebased(Fmt.YUV422),
    "default use_fused=False": lambda: _jax_file(1, True),
}


@functools.lru_cache(maxsize=None)
def _stream(kind: str) -> bytes:
    return {**STREAMS, **FUSABLE}[kind]()


def _jax_decode(data, out, **kw):
    """(output plane, metadata, gain-map image, output image) of the JAX
    package's decode."""
    dest, md, gm = jax_jpegr.JpegR().decode(
        data, output_ct=jax_types.ColorTransfer[out],
        output_fmt=JAX_OUT_FMT[out], return_gainmap=True, **kw)
    return np.asarray(dest.planes[0]), md, gm, dest


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("kind", list(STREAMS) + list(FUSABLE))
def test_general_path_matches_jax(kind, out):
    data = _stream(kind)
    use_fused = kind not in FUSABLE
    jr = port.JpegR(device="cpu")
    primary, gm, md0 = _split(data)
    plan = jr._fused_plan(port_decoder.parse_jpeg(primary),
                          port_decoder.parse_jpeg(gm), md0, CG.UNSPECIFIED,
                          CG.UNSPECIFIED)
    assert (plan is None) == use_fused       # only the general path takes it
    dest, md, gm_img = jr.decode(data, output_ct=CT[out],
                                 return_gainmap=True, use_fused=use_fused)
    want, jmd, jgm, jdest = _jax_decode(data, out, use_fused=use_fused)
    testing.check_decoded_close(dest.planes[0], want, CT[out],
                                f"{kind} {out}")
    assert (dest.w, dest.h) == (jdest.w, jdest.h) == (W, H)
    assert int(dest.fmt) == int(jdest.fmt) == int(JAX_OUT_FMT[out])
    assert int(dest.cg) == int(jdest.cg)
    assert int(gm_img.fmt) == int(jgm.fmt) and (gm_img.w, gm_img.h) == \
        (jgm.w, jgm.h) and int(gm_img.cg) == int(jgm.cg)
    np.testing.assert_array_equal(gm_img.planes[0], np.asarray(jgm.planes[0]))
    for f in ("max_content_boost", "min_content_boost", "gamma",
              "offset_sdr", "offset_hdr", "hdr_capacity_min",
              "hdr_capacity_max", "use_base_cg"):
        np.testing.assert_array_equal(np.asarray(getattr(md, f)),
                                      np.asarray(getattr(jmd, f)))


def test_stream_kinds_are_what_they_say():
    """Each made stream carries the property its name gives it."""
    def infos(kind):
        primary, gm, _ = _split(_stream(kind))
        return port_decoder.parse_jpeg(primary), port_decoder.parse_jpeg(gm)

    p, g = infos("fractional 3-channel")
    assert (g.width, g.height, g.num_components) == (45, 24, 3)
    p, g = infos("resized map")
    assert (g.width, g.height) == (34, 12)
    p, g = infos("grayscale base")
    assert p.num_components == 1
    p, g = infos("progressive base")
    assert p.progressive and not g.progressive
    p, g = infos("progressive 3-channel map")
    assert g.progressive and g.num_components == 3
    p, g = infos("subsampled 3-channel map")
    assert [(c.h, c.v) for c in g.components] == [(2, 2), (1, 1), (1, 1)]
    p, g = infos("4:2:2 use_fused=False")
    assert [(c.h, c.v) for c in p.components] == [(2, 1), (1, 1), (1, 1)]


def test_srgb_of_a_progressive_file_equals_jax():
    data = _stream("progressive base")
    got, _, gm = port.JpegR(device="cpu").decode(
        data, output_ct=CT.SRGB, return_gainmap=True)
    want, _, jgm = jax_jpegr.JpegR().decode(
        data, output_ct=jax_types.ColorTransfer.SRGB,
        output_fmt=jax_types.ImgFmt.RGBA8888, return_gainmap=True)
    np.testing.assert_array_equal(got.planes[0], np.asarray(want.planes[0]))
    np.testing.assert_array_equal(gm.planes[0], np.asarray(jgm.planes[0]))
    # a progressive gain map, returned beside the SRGB output
    data = _stream("progressive 3-channel map")
    _, _, gm = port.JpegR(device="cpu").decode(
        data, output_ct=CT.SRGB, return_gainmap=True)
    _, _, jgm = jax_jpegr.JpegR().decode(
        data, output_ct=jax_types.ColorTransfer.SRGB,
        output_fmt=jax_types.ImgFmt.RGBA8888, return_gainmap=True)
    np.testing.assert_array_equal(gm.planes[0], np.asarray(jgm.planes[0]))


def _codes(port_fn, jax_fn):
    """The UhdrErrorCodes both calls raise (each must raise)."""
    codes = []
    for fn, err in ((port_fn, port.UhdrError), (jax_fn, jax_errors.UhdrError)):
        with pytest.raises(err) as e:
            fn()
        codes.append(int(e.value.code))
    return codes


UNSUPPORTED = int(port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE)


@pytest.mark.parametrize("out", OUTS)
def test_refusals_carry_the_jax_codes(out):
    jr, jj = port.JpegR(device="cpu"), jax_jpegr.JpegR()
    ct, jct = CT[out], jax_types.ColorTransfer[out]
    # 4:4:0: the fused route takes it, the general path has no unpacker
    yuv440 = _rebased(Fmt.YUV440)
    want = _jax_decode(yuv440, out)[0]
    testing.check_decoded_close(jr.decode(yuv440, ct)[0].planes[0], want,
                                ct, f"4:4:0 fused {out}")
    assert _codes(lambda: jr.decode(yuv440, ct, use_fused=False),
                  lambda: jj.decode(yuv440, jct, use_fused=False)) == \
        [UNSUPPORTED] * 2
    # 4:1:1 and 4:1:0: no HDR output on either route
    for sampling in (Fmt.YUV411, Fmt.YUV410):
        data = _rebased(sampling)
        for use_fused in (True, False):
            assert _codes(lambda: jr.decode(data, ct, use_fused=use_fused),
                          lambda: jj.decode(data, jct,
                                            use_fused=use_fused)) == \
                [UNSUPPORTED] * 2
    # the device-resident decode has no general path
    for kind in STREAMS:
        data = _stream(kind)
        assert _codes(
            lambda: jr.decode_to_device(data, ct, microbatch=False),
            lambda: jj.decode_to_device(data, jct, microbatch=False)) == \
            [UNSUPPORTED] * 2
    data = _stream("fractional 1-channel")
    with pytest.raises(port.UhdrError) as e:
        jr.decode_to_device(data, ct)                    # microbatched
    assert int(e.value.code) == UNSUPPORTED
    with pytest.raises(port.UhdrError) as e:
        jr.decode_to_device_batch([data, data], ct)
    assert int(e.value.code) == UNSUPPORTED


@pytest.mark.parametrize("sampling", [Fmt.YUV411, Fmt.YUV410])
def test_411_and_410_decode_to_srgb(sampling):
    data = _rebased(sampling)
    got, _, _ = port.JpegR(device="cpu").decode(data, output_ct=CT.SRGB)
    want, _, _ = jax_jpegr.JpegR().decode(
        data, output_ct=jax_types.ColorTransfer.SRGB,
        output_fmt=jax_types.ImgFmt.RGBA8888)
    np.testing.assert_array_equal(got.planes[0], np.asarray(want.planes[0]))


# ---------------------------------------------------------------------------
# the decoder's engine choice


def _uhdr_decode(data, out, device="cpu"):
    dec = port.UhdrDecoder(device=device)
    dec.set_image(data)
    dec.set_out_color_transfer(CT[out])
    dec.set_out_img_format(Fmt(int(JAX_OUT_FMT[out])))
    return dec.decode(), dec.get_decoded_gainmap_image()


@pytest.mark.parametrize("engine", ["general", "auto", "device"])
def test_decode_engine_routes(engine, monkeypatch):
    monkeypatch.setenv("UHDR_TPU_DECODE_ENGINE", engine)
    jr = port.JpegR(device="cpu")
    for kind in ("default use_fused=False", "progressive base"):
        data = _stream(kind)
        img, gm = _uhdr_decode(data, "PQ")
        want, _, wgm = jr.decode(data, output_ct=CT.PQ, return_gainmap=True,
                                 use_fused=engine != "general")
        np.testing.assert_array_equal(img.planes[0], want.planes[0])
        np.testing.assert_array_equal(gm.planes[0], wgm.planes[0])
        jdec = jax_api.UhdrDecoder()
        jdec.set_image(data)
        jdec.set_out_color_transfer(jax_types.ColorTransfer.PQ)
        jdec.set_out_img_format(jax_types.ImgFmt.RGBA1010102)
        if engine == "general":
            testing.check_decoded_close(img.planes[0],
                                        np.asarray(jdec.decode().planes[0]),
                                        CT.PQ, f"{kind} {engine}")
    # the general engine takes the general path on a fusable stream, auto
    # and device the fused route: the two differ only within the contract
    data = _stream("default use_fused=False")
    fused_out = jr.decode(data, output_ct=CT.PQ)[0].planes[0]
    testing.check_decoded_close(_uhdr_decode(data, "PQ")[0].planes[0],
                                fused_out, CT.PQ, engine)


def test_fixture_is_progressive_and_decodes_like_jax():
    """The committed 4K fixture (testing.write_progressive_fixture of the
    benchmark configuration's file): a progressive 4:2:0 base with its ICC
    profile, the original 960x540 gain map; decoded on the CPU port within
    check_decoded_close of the JAX package."""
    data = testing.PROGRESSIVE_FIXTURE.read_bytes()
    assert len(data) < 2_000_000
    primary, gm, md = _split(data)
    pinfo, gm_info = port_decoder.parse_jpeg(primary), \
        port_decoder.parse_jpeg(gm)
    assert pinfo.progressive and (pinfo.width, pinfo.height) == (3840, 2160)
    assert [(c.h, c.v) for c in pinfo.components] == [(2, 2), (1, 1), (1, 1)]
    assert port_icc.read_icc_color_gamut(pinfo.icc) == CG.DISPLAY_P3
    assert not gm_info.progressive and (gm_info.width, gm_info.height) == \
        (960, 540) and gm_info.num_components == 1
    got, _, gm_img = port.JpegR(device="cpu").decode(
        data, output_ct=CT.HLG, return_gainmap=True)
    want, _, jgm, _ = _jax_decode(data, "HLG")
    testing.check_decoded_close(got.planes[0], want, CT.HLG, "fixture HLG")
    np.testing.assert_array_equal(gm_img.planes[0], np.asarray(jgm.planes[0]))
