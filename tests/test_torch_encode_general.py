"""PyTorch port: the general encode path, API-2/3/4 and the encoder's API
selection and validation against the JAX package.

The HDR is ``testing.photo_p010`` at 72x40 and its RGBA1010102 twin; the
SDR the JAX package's ``tone_map`` of it (YUV420 and RGBA8888, Display-P3);
the compressed SDR the JAX ``JpegEncoder``'s JPEG of the YUV420 SDR with a
P3 ICC profile.  The port runs on the CPU with the JAX JpegR's knobs.

- ``JpegEncoder.compress``: with the JAX package's DCT on the port's
  padded planes, the bytes equal the JAX encoder's.
- General path (``use_fused=False``) of API-0 and API-1: fed the JAX
  file's coefficients in place of its DCT (and the JAX bounds), the port
  writes the JAX file byte for byte; the JAX decoder reads the port's own
  file at >= 60 dB against the JAX file; the tone map,
  the YUV conversions and the gain map agree as u8 planes within 1 on at
  most 1e-3 of the samples (at least one), the boost bounds within 1e-5
  relative.
- API-2 and API-3: the primary image's bytes equal the JAX file's but for
  the MPF index, which holds the gain map's size; API-3's SDR planes
  decoded on the device are bit-identical to the JAX ``decode_to_planes``;
  the files decode at >= 60 dB.  API-4: the file equals the JAX file.
- ``UhdrEncoder`` selects the API the JAX encoder selects for each set of
  resources and raises the JAX error codes on invalid input; API-3 takes a
  progressive compressed SDR as the JAX encoder does.
"""

import functools
import io
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libultrahdr_tpu import api as jax_api
from libultrahdr_tpu import errors as jax_errors
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.container import icc as jax_icc
from libultrahdr_tpu.jpeg import decoder as jax_decoder
from libultrahdr_tpu.jpeg import dct as jax_dct
from libultrahdr_tpu.jpeg import encoder as jax_encoder
from libultrahdr_tpu.ops import gainmap as jax_gainmap

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.container import mpf
from libultrahdr_tpu_torch.jpeg import decoder as port_decoder
from libultrahdr_tpu_torch.jpeg import encoder as port_encoder
from libultrahdr_tpu_torch.ops import gainmap as port_gainmap

W, H = 72, 40
CPU = torch.device("cpu")
Fmt, CG, CT = port.ImgFmt, port.ColorGamut, port.ColorTransfer


def to_jax(img):
    return jax_types.RawImage(int(img.fmt), int(img.cg), int(img.ct),
                              int(img.range), img.w, img.h,
                              [np.asarray(p) for p in img.planes])


def to_port(img):
    return port.RawImage(Fmt(int(img.fmt)), CG(int(img.cg)),
                         CT(int(img.ct)), port.ColorRange(int(img.range)),
                         img.w, img.h, [np.array(p) for p in img.planes])


@functools.lru_cache(maxsize=None)
def images():
    """(P010 HDR, RGBA1010102 HDR, YUV420 SDR, RGBA8888 SDR, compressed
    SDR bytes)."""
    hdr = testing.photo_p010(W, H)
    rgb_hdr = testing.photo_rgba1010102(W, H)
    jr = jax_jpegr.JpegR()
    sdr = to_port(jr.tone_map(to_jax(hdr)))
    rgb_sdr = to_port(jr.tone_map(to_jax(rgb_hdr)))
    comp = jax_encoder.JpegEncoder().compress(
        to_jax(sdr), 95, icc=jax_icc.write_icc_profile(
            jax_types.ColorTransfer.SRGB, jax_types.ColorGamut.DISPLAY_P3))
    return hdr, rgb_hdr, sdr, rgb_sdr, comp


def close_u8(a, b):
    a, b = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    diff = np.abs(a - b)
    assert a.shape == b.shape and diff.max() <= 1
    assert (diff > 0).sum() <= max(1, 1e-3 * diff.size)


@functools.lru_cache(maxsize=None)
def jax_decode(data):
    out, _, _ = jax_jpegr.JpegR().decode(data, jax_types.ColorTransfer.HLG,
                                         jax_types.ImgFmt.RGBA1010102)
    packed = np.asarray(out.planes[0]).astype(np.int64)
    return np.stack([(packed >> s) & 1023 for s in (0, 10, 20)])


def assert_decodes_alike(port_file, jax_file):
    ref, got = jax_decode(jax_file), jax_decode(port_file)
    assert got.shape == ref.shape == (3, H, W)
    mse = np.mean((got - ref).astype(np.float64) ** 2)
    assert mse == 0 or 10 * np.log10(1023.0 ** 2 / mse) >= 60.0


def without_mpf(jpeg: bytes) -> bytes:
    """A JPEG without its MPF APP2 segment (which holds the sizes and
    offsets of the file's images)."""
    for marker, start, end in testing._segments(jpeg):
        if marker == 0xE2 and jpeg[start:start + 4] == mpf.MPF_SIG:
            return jpeg[:start - 4] + jpeg[end:]
    raise AssertionError("no MPF segment")


# ---- JpegEncoder ----------------------------------------------------------

@pytest.mark.parametrize("fmt", [Fmt.YUV420, Fmt.YUV444, Fmt.YUV400,
                                 Fmt.RGB888])
def test_jpeg_encoder_compress_equals_jax_on_equal_coefficients(fmt):
    rs = np.random.RandomState(int(fmt))
    h, w = 42, 70                    # MCU padding on both axes
    if fmt == Fmt.RGB888:
        planes = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8)]
    else:
        shapes = {Fmt.YUV420: [(h, w), (h // 2, w // 2), (h // 2, w // 2)],
                  Fmt.YUV444: [(h, w)] * 3, Fmt.YUV400: [(h, w)]}[fmt]
        planes = [rs.randint(0, 256, s).astype(np.uint8) for s in shapes]
    img = port.RawImage(fmt, CG.DISPLAY_P3, CT.SRGB, port.ColorRange.FULL,
                        w, h, planes)
    icc = b"icc-bytes"
    want = jax_encoder.JpegEncoder().compress(to_jax(img), 90, icc=icc,
                                              gainmap_comment=True)

    def jax_dct_on(padded, q):
        return torch.from_numpy(np.array(jax_dct.forward_plane(
            jnp.asarray(padded.numpy()), q)))
    with mock.patch.object(port_encoder, "forward_plane", jax_dct_on):
        got = port_encoder.JpegEncoder(CPU).compress(img, 90, icc=icc,
                                                     gainmap_comment=True)
    assert got == want


# ---- the general path ------------------------------------------------------

def general_encode(jr, case, side):
    hdr, rgb_hdr, sdr, rgb_sdr, _ = images()
    conv = to_jax if side == "jax" else (lambda x: x)
    if case == "api0":
        return jr.encode_api0(conv(hdr), 95, use_fused=False)
    h, s = (hdr, sdr) if case == "api1_yuv420" else (rgb_hdr, rgb_sdr)
    return jr.encode_api1(conv(h), conv(s), 95, use_fused=False)


@functools.lru_cache(maxsize=None)
def general_encodes(case):
    """(JAX JpegR, JAX file, port JpegR, port file, the JAX encode's
    resolved (lo, hi) or None) of a general-path request."""
    jjr, pjr = jax_jpegr.JpegR(), port.JpegR(device="cpu")
    bounds = []

    def recorded(*a, **k):
        bounds.append(resolve(*a, **k))
        return bounds[-1]
    resolve = jax_gainmap.resolve_boost_bounds
    with mock.patch.object(jax_gainmap, "resolve_boost_bounds", recorded):
        jax_file = general_encode(jjr, case, "jax")
    return (jjr, jax_file, pjr, general_encode(pjr, case, "port"),
            bounds[0] if bounds else None)


@pytest.mark.parametrize("case", ["api0", "api1_yuv420", "api1_rgba8888"])
def test_general_path_jax_coefficients_through_port_give_jax_file(case):
    """The JAX file's quantised coefficients fed to the port's general path
    in place of its DCT (the gain map's JPEG first, then the base's, as
    the encode compresses them), with the JAX encode's bounds for
    BEST_QUALITY: the JAX file, byte for byte."""
    _, jax_file, _, _, jax_bounds = general_encodes(case)
    primary, gm_jpeg, _ = testing.read_jpegr(jax_file)
    queue = []
    for jpeg in (gm_jpeg, primary):
        queue += port_decoder.decode_coefficients(
            jpeg, port_decoder.parse_jpeg(jpeg))[0]

    def jax_coefficients(padded, q):
        c = queue.pop(0)
        assert c.shape == (padded.shape[0] // 8, padded.shape[1] // 8, 64)
        return torch.from_numpy(c)
    with mock.patch.object(port_encoder, "forward_plane", jax_coefficients), \
            mock.patch.object(port_gainmap, "resolve_boost_bounds",
                              lambda *a, **k: jax_bounds):
        got = general_encode(port.JpegR(device="cpu"), case, "port")
    assert not queue and got == jax_file


@pytest.mark.parametrize("case", ["api0", "api1_yuv420", "api1_rgba8888"])
def test_general_path_matches_jax(case):
    jjr, jax_file, pjr, port_file, _ = general_encodes(case)
    assert_decodes_alike(port_file, jax_file)
    hdr, rgb_hdr, sdr, rgb_sdr, _ = images()
    if case == "api0":
        want_sdr = jjr.tone_map(to_jax(hdr))
        got_sdr = pjr.tone_map(hdr)
        for a, b in zip(got_sdr.planes, want_sdr.planes):
            close_u8(a, b)
        return
    h, s = (hdr, sdr) if case == "api1_yuv420" else (rgb_hdr, rgb_sdr)
    want_gm, want_md = jjr.generate_gainmap(to_jax(s), to_jax(h),
                                            use_luminance=True)
    got_gm, got_md = pjr.generate_gainmap(s, h, use_luminance=True)
    close_u8(got_gm.planes[0], want_gm.planes[0])
    for f in ("max_content_boost", "min_content_boost"):
        np.testing.assert_allclose(getattr(got_md, f), getattr(want_md, f),
                                   rtol=1e-5)
    want_yuv = jjr.convert_yuv_encoding(
        jjr.convert_raw_to_ycbcr(to_jax(s)) if s.fmt == Fmt.RGBA8888
        else to_jax(s), jax_types.ColorGamut.BT709,
        jax_types.ColorGamut.DISPLAY_P3)
    got_yuv = pjr.convert_yuv_encoding(
        pjr.convert_raw_to_ycbcr(s) if s.fmt == Fmt.RGBA8888 else s,
        CG.BT709, CG.DISPLAY_P3)
    assert int(got_yuv.fmt) == int(want_yuv.fmt)
    for a, b in zip(got_yuv.planes, want_yuv.planes):
        close_u8(a, b)


def test_convert_raw_to_ycbcr_matches_jax():
    _, rgb_hdr, _, rgb_sdr, _ = images()
    pjr = port.JpegR(device="cpu")
    for img in (rgb_sdr, rgb_hdr):
        for sampling in (False, True):
            want = jax_jpegr.JpegR.convert_raw_to_ycbcr(to_jax(img), sampling)
            got = pjr.convert_raw_to_ycbcr(img, sampling)
            assert int(got.fmt) == int(want.fmt)
            for a, b in zip(got.planes, want.planes):
                assert a.dtype == b.dtype
                close_u8(a, b)


# ---- API-2, API-3, API-4 ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def compressed_encodes(api):
    hdr, _, sdr, _, comp = images()
    jjr, pjr = jax_jpegr.JpegR(), port.JpegR(device="cpu")
    jc = jax_types.CompressedImage(comp, jax_types.ColorGamut.DISPLAY_P3)
    pc = port.CompressedImage(comp, CG.DISPLAY_P3)
    if api == "api2":
        return (jjr.encode_api2(to_jax(hdr), to_jax(sdr), jc),
                pjr.encode_api2(hdr, sdr, pc))
    return jjr.encode_api3(to_jax(hdr), jc), pjr.encode_api3(hdr, pc)


@pytest.mark.parametrize("api", ["api2", "api3"])
def test_api2_api3_match_jax(api):
    jax_file, port_file = compressed_encodes(api)
    jp, jg, _ = testing.read_jpegr(jax_file)
    pp, pg, _ = testing.read_jpegr(port_file)
    assert without_mpf(pp) == without_mpf(jp)
    assert_decodes_alike(port_file, jax_file)
    hdr, _, sdr, _, comp = images()
    if api == "api3":
        want, wfmt = jax_decoder.decode_to_planes(comp)
        got, gfmt = port_decoder.decode_to_planes(comp, None, device=CPU)
        assert int(gfmt) == int(wfmt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        sdr = port.RawImage(gfmt, CG.DISPLAY_P3, CT.SRGB,
                            port.ColorRange.FULL, W, H, got)
    want_gm, _ = jax_jpegr.JpegR().generate_gainmap(
        to_jax(sdr), to_jax(hdr), sdr_is_601=api == "api3",
        use_luminance=True)
    got_gm, _ = port.JpegR(device="cpu").generate_gainmap(
        sdr, hdr, sdr_is_601=api == "api3", use_luminance=True)
    close_u8(got_gm.planes[0], want_gm.planes[0])


def _with_exif(jpeg: bytes) -> bytes:
    tiff = b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08" + bytes(range(40))
    seg = b"\xff\xe1" + (len(tiff) + 2).to_bytes(2, "big") + tiff
    return jpeg[:2] + seg + jpeg[2:]


@pytest.mark.parametrize("exif,icc", [(True, False), (False, True)])
def test_api4_equals_jax(exif, icc):
    hdr, _, sdr, _, comp = images()
    gm = jax_jpegr.JpegR().compress_gainmap(jax_jpegr.JpegR().generate_gainmap(
        to_jax(sdr), to_jax(hdr), use_luminance=True)[0])
    if icc:
        base = comp
    else:
        base = jax_encoder.JpegEncoder().compress(to_jax(sdr), 95)
    if exif:
        base = _with_exif(base)
    md = port.GainMapMetadata()
    md.max_content_boost[:] = [4.5, 3.25, 2.0]
    md.min_content_boost[:] = [1.0, 0.75, 0.5]
    md.hdr_capacity_max = 4.5
    md.use_base_cg = True
    jmd = jax_types.GainMapMetadata(**{
        f: getattr(md, f) for f in ("max_content_boost", "min_content_boost",
                                    "gamma", "offset_sdr", "offset_hdr",
                                    "hdr_capacity_min", "hdr_capacity_max",
                                    "use_base_cg")})
    want = jax_jpegr.JpegR().encode_api4(
        jax_types.CompressedImage(base, jax_types.ColorGamut.DISPLAY_P3),
        jax_types.CompressedImage(gm), jmd)
    enc = port.UhdrEncoder(device="cpu")
    enc.set_compressed_image(port.CompressedImage(base, CG.DISPLAY_P3),
                             port.ImgLabel.BASE)
    enc.set_gainmap_image(port.CompressedImage(gm), md)
    got = enc.encode()
    assert got == want
    primary, gm_out, _ = testing.read_jpegr(got)
    for out, given in ((primary, base), (gm_out, gm)):
        assert testing.without_app_segments(out) == \
            testing.without_app_segments(given)


# ---- UhdrEncoder: API selection and validation ----------------------------

RESOURCES = {
    "hdr": ("api0",), "hdr+sdr": ("api1",), "hdr+sdr_jpeg": ("api3",),
    "hdr+sdr+sdr_jpeg": ("api2",), "base+gainmap": ("api4",),
    "base+gainmap+hdr": ("api4",), "sdr": (None,), "nothing": (None,)}


def _configure(enc, names, ns):
    hdr, _, sdr, _, comp = images()
    conv = to_jax if ns is jax_types else (lambda x: x)
    if "hdr" in names:
        enc.set_raw_image(conv(hdr), ns.ImgLabel.HDR)
    if "sdr" in names:
        enc.set_raw_image(conv(sdr), ns.ImgLabel.SDR)
    if "sdr_jpeg" in names:
        enc.set_compressed_image(ns.CompressedImage(comp),
                                 ns.ImgLabel.SDR)
    if "base" in names:
        enc.set_compressed_image(ns.CompressedImage(comp), ns.ImgLabel.BASE)
    if "gainmap" in names:
        md = ns.GainMapMetadata()
        md.hdr_capacity_max = 2.0
        enc.set_gainmap_image(ns.CompressedImage(comp), md)


@pytest.mark.parametrize("resources", RESOURCES)
def test_encoder_selects_the_api_jax_selects(resources):
    names = resources.split("+")
    results = []
    for ns, enc, cls in ((jax_types, jax_api.UhdrEncoder(),
                          jax_jpegr.JpegR),
                         (port, port.UhdrEncoder(device="cpu"),
                          port.JpegR)):
        _configure(enc, names, ns)
        with mock.patch.multiple(cls, **{
                f"encode_api{i}": (lambda i: lambda *a, **k: f"api{i}")(i)
                for i in range(5)}):
            try:
                results.append(enc.encode())
            except (jax_errors.UhdrError, port.UhdrError) as e:
                results.append(("error", int(e.code)))
    assert results[0] == results[1]
    want = RESOURCES[resources][0]
    assert results[1] == want if want else results[1][0] == "error"


def _bad_metadata(**kw):
    def make(ns):
        md = ns.GainMapMetadata()
        for k, v in kw.items():
            if isinstance(getattr(md, k), np.ndarray):
                getattr(md, k)[:] = v
            else:
                setattr(md, k, v)
        return md
    return make


def _raw(fmt, ct, w=W, h=H, cg=CG.BT709, rng=port.ColorRange.FULL,
         nplanes=3):
    planes = {Fmt.YUV420: [np.zeros((h, w), np.uint8),
                           np.zeros((h // 2, w // 2), np.uint8),
                           np.zeros((h // 2, w // 2), np.uint8)],
              Fmt.P010: [np.zeros((h, w), np.uint16),
                         np.zeros((h // 2, w), np.uint16)]}.get(
        fmt, [np.zeros((h, w), np.uint32)])
    return port.RawImage(fmt, cg, ct, rng, w, h, planes[:nplanes])


INVALID = {
    "sdr_p010": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.P010, CT.SRGB)), port.ImgLabel.SDR),
    "sdr_rgba1010102": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.RGBA1010102, CT.SRGB)), port.ImgLabel.SDR),
    "sdr_hlg": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.YUV420, CT.HLG)), port.ImgLabel.SDR),
    "sdr_odd": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.YUV420, CT.SRGB, w=71)), port.ImgLabel.SDR),
    "sdr_small": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.RGBA8888, CT.SRGB, w=6)), port.ImgLabel.SDR),
    "sdr_two_planes": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.YUV420, CT.SRGB, nplanes=2)), port.ImgLabel.SDR),
    "sdr_limited": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.YUV420, CT.SRGB, rng=port.ColorRange.LIMITED)),
        port.ImgLabel.SDR),
    "sdr_gamut": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.RGBA8888, CT.SRGB, cg=CG.UNSPECIFIED)),
        port.ImgLabel.SDR),
    "dims_differ": lambda e, ns, c: (
        e.set_raw_image(c(_raw(Fmt.P010, CT.HLG)), port.ImgLabel.HDR),
        e.set_raw_image(c(_raw(Fmt.YUV420, CT.SRGB, w=64)),
                        port.ImgLabel.SDR)),
    "base_intent": lambda e, ns, c: e.set_raw_image(
        c(_raw(Fmt.YUV420, CT.SRGB)), port.ImgLabel.BASE),
    "compressed_empty": lambda e, ns, c: e.set_compressed_image(
        ns.CompressedImage(b""), port.ImgLabel.SDR),
    "compressed_gainmap_intent": lambda e, ns, c: e.set_compressed_image(
        ns.CompressedImage(b"x"), port.ImgLabel.GAIN_MAP),
    "md_max_below_min": lambda e, ns, c: e.set_gainmap_image(
        ns.CompressedImage(b"x"), _bad_metadata(
            max_content_boost=0.5)(ns)),
    "md_min_zero": lambda e, ns, c: e.set_gainmap_image(
        ns.CompressedImage(b"x"), _bad_metadata(
            min_content_boost=0.0, max_content_boost=2.0)(ns)),
    "md_gamma": lambda e, ns, c: e.set_gainmap_image(
        ns.CompressedImage(b"x"), _bad_metadata(gamma=0.0)(ns)),
    "md_offset": lambda e, ns, c: e.set_gainmap_image(
        ns.CompressedImage(b"x"), _bad_metadata(offset_sdr=-1.0)(ns)),
    "md_capacity": lambda e, ns, c: e.set_gainmap_image(
        ns.CompressedImage(b"x"), _bad_metadata(
            hdr_capacity_min=2.0, hdr_capacity_max=1.5)(ns)),
    "md_nan": lambda e, ns, c: e.set_gainmap_image(
        ns.CompressedImage(b"x"), _bad_metadata(
            hdr_capacity_max=float("nan"))(ns)),
    "boost_order": lambda e, ns, c: e.set_min_max_content_boost(2.0, 1.0),
    "boost_zero": lambda e, ns, c: e.set_min_max_content_boost(0.0, 1.0),
    "boost_inf": lambda e, ns, c: e.set_min_max_content_boost(1.0,
                                                          float("inf")),
    "target_nits": lambda e, ns, c: e.set_target_display_peak_brightness(100.0),
    "preset": lambda e, ns, c: e.set_preset(7),
    "output_format": lambda e, ns, c: e.set_output_format(port.Codec.HEIF),
    "exif_empty": lambda e, ns, c: e.set_exif_data(b""),
}


@pytest.mark.parametrize("case", INVALID)
def test_encoder_validation_raises_the_jax_codes(case):
    codes = []
    for ns, err, enc, conv in (
            (jax_types, jax_errors.UhdrError, jax_api.UhdrEncoder(), to_jax),
            (port, port.UhdrError, port.UhdrEncoder(device="cpu"),
             lambda x: x)):
        with pytest.raises(err) as e:
            INVALID[case](enc, ns, conv)
        codes.append(int(e.value.code))
    assert codes[0] == codes[1]


def test_progressive_compressed_sdr_raises_unsupported():
    """A progressive compressed SDR intent (API-3) no longer raises: its
    planes come from the general decode path's progressive decoder, as in
    the JAX package.  The name is the test's from when the port refused
    it.  A progressive JPEG of the SDR (PIL, with the P3 ICC profile)
    gives API-3 files whose primary images are equal but for the MPF index
    and which decode alike, from SDR planes decoded bit-exactly."""
    Image = pytest.importorskip("PIL.Image")
    hdr, _, sdr, _, comp = images()
    rgb = port_decoder.decode_to_rgb(comp, None, CPU).permute(1, 2, 0)
    buf = io.BytesIO()
    Image.fromarray(rgb.numpy()).save(
        buf, "JPEG", progressive=True, quality=90, subsampling=2,
        icc_profile=Image.open(io.BytesIO(comp)).info["icc_profile"])
    progressive = buf.getvalue()
    assert port_decoder.parse_jpeg(progressive).progressive
    want, wfmt = jax_decoder.decode_to_planes(progressive)
    got, gfmt = port_decoder.decode_to_planes(progressive, None, device=CPU)
    assert int(gfmt) == int(wfmt) == int(Fmt.YUV420)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    enc = port.UhdrEncoder(device="cpu")
    enc.set_raw_image(hdr, port.ImgLabel.HDR)
    enc.set_compressed_image(port.CompressedImage(progressive,
                                                  CG.DISPLAY_P3),
                             port.ImgLabel.SDR)
    port_file = enc.encode()
    jenc = jax_api.UhdrEncoder()
    jenc.set_raw_image(to_jax(hdr), jax_types.ImgLabel.HDR)
    jenc.set_compressed_image(jax_types.CompressedImage(
        progressive, jax_types.ColorGamut.DISPLAY_P3), jax_types.ImgLabel.SDR)
    jax_file = jenc.encode()
    pp, _, _ = testing.read_jpegr(port_file)
    jp, _, _ = testing.read_jpegr(jax_file)
    assert without_mpf(pp) == without_mpf(jp)
    assert port_decoder.parse_jpeg(pp).progressive
    assert_decodes_alike(port_file, jax_file)
