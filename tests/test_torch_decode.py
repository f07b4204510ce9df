"""PyTorch port: the fused JPEG_R decode against the JAX package.

- The integer stages are bit-exact: ``inverse_plane`` (dequant, islow IDCT
  with int32 wrap, libjpeg's range-limit table) and ``_ycc_to_rgb`` (fancy
  upsample, fixed-point YCbCr->RGB); the host parse and Huffman decode give
  the JAX package's JpegInfo, coefficients and quant tables.
- The whole slice: files written by the port's encoder and by the JAX
  encoder, in both configurations of the main path (library default: map
  scale 1, 3 channels; reference benchmark: scale 4, 1 channel), decoded by
  ``UhdrDecoder(device="cpu")`` and by the JAX ``JpegR().decode``.  Gain-map
  planes and metadata are equal; the outputs are within
  ``testing.check_decoded_close``'s contract (an ulp of the float math may
  move a value across one step of a LUT grid: 10-bit codes equal or
  neighbouring attainable codes of the OETF grid, within 1 away from black,
  on at most 5e-3 of the samples; half floats equal except on at most 1e-3
  of the samples, within 4 ulps; PSNR >= 60 dB).
- ``UhdrDecoder``'s lifecycle and validation, mirrored from tests/test_api.py;
  the device-resident decode refuses the streams only the general path
  takes, with the JAX package's ``unsupported``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import benchmarks
from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu.jpeg import dct as jax_dct
from libultrahdr_tpu.jpeg import decoder as jax_decoder
from libultrahdr_tpu.types import ColorTransfer as JaxTransfer
from libultrahdr_tpu.types import ImgFmt as JaxFmt

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg import dct as port_dct
from libultrahdr_tpu_torch.jpeg import decoder as port_decoder

W, H = 136, 72          # MCU padding on both axes; divisible by the scale 4
CONFIGS = {
    "default": {},
    "benchmark": {"map_dimension_scale_factor": 4,
                  "use_multi_channel_gainmap": False},
}
OUTPUTS = {"HLG": (port.ColorTransfer.HLG, port.ImgFmt.RGBA1010102),
           "PQ": (port.ColorTransfer.PQ, port.ImgFmt.RGBA1010102),
           "LINEAR": (port.ColorTransfer.LINEAR, port.ImgFmt.RGBAF16)}


@functools.lru_cache(maxsize=None)
def _files(cfg, w=W, h=H):
    """{"jax": JAX-written file, "port": port-written file}."""
    kw = CONFIGS[cfg]
    jax_file = jax_jpegr.JpegR(**kw).encode_api0(benchmarks.photo_p010(w, h),
                                                 95)
    enc = port.UhdrEncoder(device="cpu")
    enc.set_raw_image(testing.photo_p010(w, h), port.ImgLabel.HDR)
    enc.set_gainmap_scale_factor(kw.get("map_dimension_scale_factor", 1))
    enc.set_using_multi_channel_gainmap(
        kw.get("use_multi_channel_gainmap", True))
    return {"jax": jax_file, "port": enc.encode()}


def _port_decode(data, out):
    ct, fmt = OUTPUTS[out]
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(data)
    dec.set_out_color_transfer(ct)
    dec.set_out_img_format(fmt)
    return dec.decode(), dec.get_decoded_gainmap_image(), \
        dec.get_gainmap_metadata()


# ---------------------------------------------------------------------------
# integer stages, bit-exact


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_plane_bit_exact_with_int32_wrap(seed):
    """Coefficients up to +-32767 times quant steps up to 65535 overflow
    int32 inside the butterfly; range_limit then takes all three branches
    (m < 256, 256 <= m < 640, m >= 640)."""
    rs = np.random.RandomState(seed)
    c = rs.randint(-32768, 32768, (6, 9, 64)).astype(np.int16)
    c[:2] = rs.randint(-40, 41, (2, 9, 64))          # ordinary blocks
    c[2, :, 1:] = 0                                  # flat blocks
    q = rs.randint(1, 65536, 64).astype(np.int32)
    q[:8] = rs.randint(1, 12, 8)
    want = np.asarray(jax_dct.inverse_plane(jnp.asarray(c), q, 45, 67))
    got = port_dct.inverse_plane(torch.from_numpy(c), q, 45, 67)
    assert got.dtype == torch.uint8 and got.shape == (45, 67)
    np.testing.assert_array_equal(got.numpy(), want)
    nat = torch.from_numpy(c)[..., torch.from_numpy(
        port_dct.INV_ZIGZAG).long()].to(torch.int32) * torch.from_numpy(q)
    m = (port_dct.idct8x8_islow(nat.reshape(6, 9, 8, 8)) + 128) & 1023
    assert (m < 256).any() and ((m >= 256) & (m < 640)).any() \
        and (m >= 640).any()


@pytest.mark.parametrize("fmt_key,sub", [("444", (1, 1)), ("420", (2, 2)),
                                         ("422", (2, 1)), ("440", (1, 2)),
                                         ("411", (4, 1)), ("410", (4, 2))])
def test_ycc_to_rgb_bit_exact(fmt_key, sub):
    h, w = 37, 53
    rs = np.random.RandomState(len(fmt_key) + sub[0] * 3 + sub[1])
    y = rs.randint(0, 256, (h + 3, w + 5)).astype(np.uint8)
    cb, cr = (rs.randint(0, 256, (-(-h // sub[1]), -(-w // sub[0])))
              .astype(np.uint8) for _ in range(2))
    want = np.asarray(jax_decoder._ycc_to_rgb(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), fmt_key, h, w))
    got = port_decoder._ycc_to_rgb(torch.from_numpy(y), torch.from_numpy(cb),
                                   torch.from_numpy(cr), fmt_key, h, w)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def _info_dict(info):
    d = dataclasses.asdict(info)
    for key in ("dc_tables", "ac_tables"):
        d[key] = {i: (t.bits, t.values) for i, t in getattr(info, key).items()}
    d["qtables"] = {i: q.tolist() for i, q in info.qtables.items()}
    return d


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_parse_and_decode_coefficients_match_jax(cfg, writer):
    data = _files(cfg)[writer]
    jparts = jax_jpegr.JpegR.extract_primary_and_gainmap(data)
    pparts = port.JpegR.extract_primary_and_gainmap(data)
    assert jparts == pparts
    for jpeg in pparts:
        for parse_only in (True, False):
            assert _info_dict(port_decoder.parse_jpeg(jpeg, parse_only)) == \
                _info_dict(jax_decoder.parse_jpeg(jpeg, parse_only))
        jc, jq, jfmt = jax_fused.decode_coefficients(
            jpeg, jax_decoder.parse_jpeg(jpeg))
        pc, pq, pfmt = port_fused.decode_coefficients(
            jpeg, port_decoder.parse_jpeg(jpeg))
        assert int(jfmt) == int(pfmt)
        for a, b in zip(jc + jq, pc + pq):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_get_info_matches_jax(cfg):
    """JpegR.get_info (getJPEGRInfo): dimensions and the parse-only JpegInfo
    of both images equal the JAX package's."""
    data = _files(cfg)["port"]
    got = port.JpegR(device="cpu").get_info(data)
    want = jax_jpegr.JpegR().get_info(data)
    assert (got["width"], got["height"]) == (want["width"], want["height"])
    for key in ("primary", "gainmap"):
        assert _info_dict(got[key]) == _info_dict(want[key])


# ---------------------------------------------------------------------------
# the whole slice


@functools.lru_cache(maxsize=None)
def _jax_decode(data, out):
    ct, fmt = OUTPUTS[out]
    return jax_jpegr.JpegR().decode(data, JaxTransfer(int(ct)),
                                    JaxFmt(int(fmt)), return_gainmap=True)


@pytest.mark.parametrize("out", list(OUTPUTS))
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_decode_matches_jax(cfg, writer, out):
    data = _files(cfg)[writer]
    jdest, jmd, jgm = _jax_decode(data, out)
    dest, gm, md = _port_decode(data, out)
    assert (dest.w, dest.h, int(dest.fmt), int(dest.cg), int(dest.ct)) == \
        (jdest.w, jdest.h, int(jdest.fmt), int(jdest.cg), int(jdest.ct))
    assert dest.planes[0].dtype == np.asarray(jdest.planes[0]).dtype
    err, _ = testing.check_decoded_close(
        dest.planes[0], np.asarray(jdest.planes[0]), OUTPUTS[out][0],
        f"{cfg} {writer} {out}")
    if out != "LINEAR":
        # within 1, as between the JAX package's own two decode paths
        assert err <= 1
    assert (gm.w, gm.h, int(gm.fmt)) == (jgm.w, jgm.h, int(jgm.fmt))
    np.testing.assert_array_equal(gm.planes[0], np.asarray(jgm.planes[0]))
    for f in dataclasses.fields(md):
        np.testing.assert_array_equal(getattr(md, f.name),
                                      getattr(jmd, f.name))


@pytest.mark.parametrize("out", list(OUTPUTS))
def test_decoded_close_refuses_a_rounding_fault(out):
    """The contract between programs refuses a systematic rounding fault
    (floor for rint): every other red sample one code or one half-float ulp
    up stays within the per-sample limit and above 60 dB, but far more
    samples differ than an ulp of the float math moves."""
    dest, _, _ = _port_decode(_files("default")["port"], out)
    good = dest.planes[0]
    testing.check_decoded_close(good, good.copy(), OUTPUTS[out][0])
    bad = good.copy()
    if out == "LINEAR":
        bad[:, ::2, 0] += 1
    else:
        cols = bad[:, ::2]
        cols += (cols & 1023) < 1023
    with pytest.raises(AssertionError, match="of samples differ"):
        testing.check_decoded_close(bad, good, OUTPUTS[out][0])


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_decode_to_device_and_jpegr_decode_agree(cfg):
    """JpegR.decode_to_device leaves the packed output on the device in the
    int32 / int16 carriers; JpegR.decode downloads the same values."""
    data = _files(cfg)["port"]
    jr = port.JpegR(device="cpu")
    for out, (ct, fmt) in OUTPUTS.items():
        packed, md = jr.decode_to_device(data, ct)
        dest, md2, gm = jr.decode(data, ct, fmt)
        assert gm is None
        for f in dataclasses.fields(md):
            np.testing.assert_array_equal(getattr(md, f.name),
                                          getattr(md2, f.name))
        assert packed.device.type == "cpu"
        assert packed.dtype == (torch.int16 if out == "LINEAR"
                                else torch.int32)
        np.testing.assert_array_equal(testing.host_packed(packed),
                                      dest.planes[0])


# ---------------------------------------------------------------------------
# UhdrDecoder lifecycle, validation, unsupported shapes


def test_decoder_probe_getters():
    data = _files("benchmark")["port"]
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(data)
    assert dec.get_image_width() == -1       # not probed yet
    dec.probe()
    assert (dec.get_image_width(), dec.get_image_height()) == (W, H)
    assert (dec.get_gainmap_width(), dec.get_gainmap_height()) == \
        (W // 4, H // 4)
    assert dec.get_icc() is not None
    primary, gm = port.JpegR.extract_primary_and_gainmap(data)
    assert dec.get_base_image() == primary and dec.get_gainmap_image() == gm
    assert dec.get_gainmap_metadata().hdr_capacity_max > 1.0
    assert dec.get_exif() is None


def test_decoder_defaults_fmt_ct_pairing_and_lifecycle():
    data = _files("default")["port"]
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(data)
    img = dec.decode()                      # defaults: RGBAF16 / LINEAR
    assert (img.w, img.h, port.ImgFmt(img.fmt)) == (W, H, port.ImgFmt.RGBAF16)
    assert dec.decode() is img and dec.get_decoded_image() is img
    assert dec.get_decoded_gainmap_image().planes[0].shape == (H, W, 3)
    with pytest.raises(port.UhdrError) as e:
        dec.set_out_color_transfer(port.ColorTransfer.HLG)     # sailed
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_OPERATION
    dec.reset()
    assert dec.get_decoded_image() is None
    for fmt, ct in [(port.ImgFmt.RGBA1010102, port.ColorTransfer.SRGB),
                    (port.ImgFmt.RGBA1010102, port.ColorTransfer.LINEAR),
                    (port.ImgFmt.RGBAF16, port.ColorTransfer.HLG),
                    (port.ImgFmt.RGBA8888, port.ColorTransfer.LINEAR)]:
        dec = port.UhdrDecoder(device="cpu")
        dec.set_image(data)
        dec.set_out_img_format(fmt)
        dec.set_out_color_transfer(ct)
        with pytest.raises(port.UhdrError) as e:
            dec.decode()
        assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM
    dec = port.UhdrDecoder(device="cpu")
    for bad in (lambda: dec.set_out_max_display_boost(0.5),
                lambda: dec.set_out_img_format(port.ImgFmt.YUV420),
                lambda: dec.set_out_color_transfer(
                    port.ColorTransfer.UNSPECIFIED),
                lambda: dec.set_image(b"")):
        with pytest.raises(port.UhdrError) as e:
            bad()
        assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM
    dec.set_out_max_display_boost(1.0)
    with pytest.raises(port.UhdrError) as e:
        dec.probe()                                     # no image
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_OPERATION
    dec.set_image(b"\xff\xd8\xff\xd9garbage")
    with pytest.raises(port.UhdrError):
        dec.decode()


def test_max_display_boost_weights_the_gain():
    """A display boost of 1 gives weight 0: the HDR output is the SDR base
    (the gain map does nothing), so it differs from the full-boost one."""
    data = _files("default")["port"]
    outs = []
    for boost in (1.0, 1000.0 / 203.0):
        dec = port.UhdrDecoder(device="cpu")
        dec.set_image(data)
        dec.set_out_max_display_boost(boost)
        outs.append(dec.decode().planes[0])
    assert not np.array_equal(outs[0], outs[1])


def test_unsupported_decode_shapes_raise():
    """The streams that only the general path takes (here a base marked
    progressive, a map that does not divide the image, and
    ``use_fused=False``) decode through ``JpegR.decode`` within the
    contract of the JAX package's decode; the device-resident decode has
    no general path and raises ``unsupported`` for them, as the JAX
    package's does (tests/test_torch_decode_general.py holds every stream
    kind)."""
    data = _files("default")["port"]
    jr = port.JpegR(device="cpu")
    # a device-resident decode gives HDR outputs only, as in the JAX
    # package (SRGB output is JpegR.decode's, tests/test_torch_decode_batch)
    with pytest.raises(port.UhdrError) as e:
        jr.decode_to_device(data, port.ColorTransfer.SRGB)
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE
    primary, _ = jr.extract_primary_and_gainmap(data)
    sof = data.index(b"\xff\xc0")
    assert sof < len(primary)
    for what, stream, use_fused in (
            ("use_fused=False", data, False),
            ("a base marked progressive (SOF2 in place of SOF0)",
             data[:sof] + b"\xff\xc2" + data[sof + 2:], True),
            ("a map that does not divide the image",
             _files("benchmark", 130, 66)["port"], True)):
        got, _, _ = jr.decode(stream, use_fused=use_fused)
        want, _, _ = jax_jpegr.JpegR().decode(stream, use_fused=use_fused)
        testing.check_decoded_close(got.planes[0],
                                    np.asarray(want.planes[0]),
                                    port.ColorTransfer.HLG, what)
        if use_fused:
            codes = []
            for fn in (lambda: jr.decode_to_device(stream, microbatch=False),
                       lambda: jax_jpegr.JpegR().decode_to_device(
                           stream, microbatch=False)):
                with pytest.raises(Exception) as e:
                    fn()
                codes.append(int(e.value.code))
            assert codes == [int(
                port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE)] * 2
