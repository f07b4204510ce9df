"""PyTorch port: the native host decode engine against the JAX package.

``JpegR.decode_host`` runs the Huffman decode, the AAN float IDCT and the
fused apply in the host C++ (the port's own copy of the JAX package's
``host_decode.cpp``), touching no tensor.  The port builds that C++ with the
JAX package's flags (``-O3 -march=native -fno-math-errno``), so on one host
the two engines agree bit for bit:

- the bound functions (``idct_plane``, ``ycbcr_to_rgb_planar``,
  ``apply_gainmap_host``) equal the JAX package's on seeded inputs;
- ``decode_host`` of JAX-written files (map scale 1, 2 and 4, 1 and 3
  channels, gamma 1 and 2.2) to HLG, PQ and LINEAR equals the JAX
  package's, output, metadata and returned gain map;
- it raises ``unsupported`` for exactly the streams the JAX engine refuses,
  with the JAX codes;
- against the port's device decode it holds the JAX package's own gate
  (tests/test_host_decode.py): >= 55 dB a channel, its IDCT not being
  libjpeg's islow;
- ``UHDR_TPU_DECODE_ENGINE=host`` routes ``UhdrDecoder`` to it, with no
  retry on another engine, and an SRGB decode to the host engine of
  ``JpegR.decode``, whose output equals the JAX decoder's.
"""

import functools
import io

import numpy as np
import pytest

import benchmarks
from libultrahdr_tpu import api as jax_api
from libultrahdr_tpu import errors as jax_errors
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.jpeg import native as jax_native

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import _buildlib as buildlib
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.container import icc as port_icc
from libultrahdr_tpu_torch.jpeg import decoder as port_decoder
from libultrahdr_tpu_torch.jpeg import native as port_native
from libultrahdr_tpu_torch.jpeg.encoder import JpegEncoder

W, H = 128, 96
CG, CT, Fmt = port.ColorGamut, port.ColorTransfer, port.ImgFmt
OUTS = ("HLG", "PQ", "LINEAR")
UNSUPPORTED = int(port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE)


@functools.lru_cache(maxsize=None)
def _file(scale: int, multichannel: bool, gamma: float = 1.0) -> bytes:
    return jax_jpegr.JpegR(
        map_dimension_scale_factor=scale,
        use_multi_channel_gainmap=multichannel, gamma=gamma,
        preset=jax_types.EncPreset.REALTIME).encode_api0(
            benchmarks.photo_p010(W, H), 92)


def test_host_bindings_equal_jax():
    rs = np.random.RandomState(5)
    coeffs = rs.randint(-60, 61, (7, 9, 64)).astype(np.int16)
    coeffs[..., 0] = rs.randint(-900, 900, (7, 9))
    q = rs.randint(1, 40, 64).astype(np.int32)
    np.testing.assert_array_equal(port_native.idct_plane(coeffs, q),
                                  jax_native.idct_plane(coeffs, q))
    y, cb, cr = (rs.randint(0, 256, (29, 43)).astype(np.uint8)
                 for _ in range(3))
    np.testing.assert_array_equal(port_native.ycbcr_to_rgb_planar(y, cb, cr),
                                  jax_native.ycbcr_to_rgb_planar(y, cb, cr))
    yp = rs.randint(0, 256, (48, 64)).astype(np.uint8)
    up, vp = (rs.randint(0, 256, (24, 32)).astype(np.uint8)
              for _ in range(2))
    meta = np.array([1.0] * 3 + [1.0] * 3 + [4.9] * 3 + [1 / 64] * 6,
                    np.float32)
    gamut = np.array([[0.8, 0.15, 0.05], [0.05, 0.9, 0.05],
                      [0.0, 0.1, 0.9]], np.float32)
    for gm, k, planar in ((rs.randint(0, 256, (12, 16)).astype(np.uint8),
                           4, False),
                          (rs.randint(0, 256, (3, 24, 32)).astype(np.uint8),
                           2, True)):
        for out_ct in (0, 1, 2):
            args = (yp, up, vp, 2, 2, 61, 45, gm, k, meta, 0.7, out_ct,
                    gamut, planar, planar)
            np.testing.assert_array_equal(
                port_native.apply_gainmap_host(*args),
                jax_native.apply_gainmap_host(*args))


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("scale,multichannel,gamma", [
    (1, True, 1.0), (2, True, 1.0), (4, False, 1.0), (1, False, 2.2)])
def test_decode_host_equals_jax(scale, multichannel, gamma, out):
    data = _file(scale, multichannel, gamma)
    dest, md, gm = port.JpegR(device="cpu").decode_host(
        data, CT[out], return_gainmap=True)
    jdest, jmd, jgm = jax_jpegr.JpegR().decode_host(
        data, jax_types.ColorTransfer[out], return_gainmap=True)
    assert (int(dest.fmt), int(dest.cg), dest.w, dest.h) == \
        (int(jdest.fmt), int(jdest.cg), jdest.w, jdest.h)
    got, want = dest.planes[0], np.asarray(jdest.planes[0])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (int(gm.fmt), int(gm.cg), gm.w, gm.h) == \
        (int(jgm.fmt), int(jgm.cg), jgm.w, jgm.h)
    np.testing.assert_array_equal(gm.planes[0], np.asarray(jgm.planes[0]))
    assert md.hdr_capacity_max == jmd.hdr_capacity_max
    two = port.JpegR(device="cpu").decode_host(data, CT[out])
    assert len(two) == 2
    np.testing.assert_array_equal(two[0].planes[0], got)


def _psnr10(a, b, shift):
    ca = ((a.astype(np.int64) >> shift) & 0x3FF).astype(np.float64)
    cb = ((b.astype(np.int64) >> shift) & 0x3FF).astype(np.float64)
    mse = np.mean((ca - cb) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1023.0 ** 2 / mse)


@pytest.mark.parametrize("out", ["HLG", "PQ"])
@pytest.mark.parametrize("scale,multichannel", [(1, True), (4, False)])
def test_decode_host_against_the_device_decode(scale, multichannel, out):
    """The JAX package's host-vs-device gate: >= 55 dB per 10-bit
    channel against the port's decode of the same file."""
    data = _file(scale, multichannel)
    jr = port.JpegR(device="cpu")
    host = jr.decode_host(data, CT[out])[0].planes[0]
    dev = jr.decode(data, CT[out])[0].planes[0]
    for s in (0, 10, 20):
        assert _psnr10(host, dev, s) >= 55.0


@pytest.mark.parametrize("gamma,multichannel", [(1.5, False), (2.2, True)])
def test_decode_host_scale1_gamma(gamma, multichannel):
    """tests/test_host_decode.py's case on the port: at map scale 1 the
    host engine composes gamma, quantisation and gain into one 256-entry
    table; with a gamma other than 1 it holds the same gate against the
    port's device decode."""
    data = _file(1, multichannel, gamma)
    jr = port.JpegR(device="cpu")
    host = jr.decode_host(data, CT.HLG)[0].planes[0]
    dev = jr.decode(data, CT.HLG)[0].planes[0]
    for s in (0, 10, 20):
        assert _psnr10(host, dev, s) >= 55.0


def _replaced(data: bytes, base: bytes | None = None,
              gm: bytes | None = None) -> bytes:
    """`data` with its base or its gain map replaced, through API-4."""
    primary, gm0 = port.JpegR.extract_primary_and_gainmap(data)
    pinfo, ginfo = port_decoder.parse_jpeg(primary), \
        port_decoder.parse_jpeg(gm0)
    md = port.JpegR.parse_gainmap_metadata(ginfo.iso, ginfo.xmp, pinfo.exif)
    return port.JpegR(device="cpu").encode_api4(
        port.CompressedImage(testing.without_app_segments(
            base or primary, True), CG.DISPLAY_P3),
        port.CompressedImage(testing.without_app_segments(gm or gm0, True)),
        md)


def _with_base(data: bytes, fmt) -> bytes:
    """`data` with its base re-encoded at another sampling."""
    primary, _ = port.JpegR.extract_primary_and_gainmap(data)
    (y, u, v), _ = port_decoder.decode_to_planes(primary, None, device="cpu")
    full = [np.repeat(np.repeat(c.numpy(), 2, 0), 2, 1) for c in (u, v)]
    hs, vs = {Fmt.YUV411: (4, 1), Fmt.YUV400: (0, 0)}[fmt]
    planes = [y.numpy()] + ([np.ascontiguousarray(c[::vs, ::hs])
                             for c in full] if hs else [])
    img = port.RawImage(fmt, CG.DISPLAY_P3, CT.SRGB, port.ColorRange.FULL,
                        W, H, planes)
    icc = port_icc.write_icc_profile(CT.SRGB, CG.DISPLAY_P3)
    return _replaced(data, base=JpegEncoder("cpu").compress(img, 95, icc=icc))


def _subsampled_map(data: bytes) -> bytes:
    Image = pytest.importorskip("PIL.Image")
    _, gm = port.JpegR.extract_primary_and_gainmap(data)
    rgb = port_decoder.decode_to_rgb(gm, None, "cpu").permute(1, 2, 0)
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb.numpy())).save(
        buf, "JPEG", quality=95, subsampling=2,
        icc_profile=Image.open(io.BytesIO(gm)).info.get("icc_profile"))
    return _replaced(data, gm=buf.getvalue())


REFUSED = {
    "progressive base": lambda: (lambda d, i: d[:i] + b"\xff\xc2" + d[i + 2:])(
        _file(4, False), _file(4, False).index(b"\xff\xc0")),
    "fractional map scale": lambda: jax_jpegr.JpegR(
        map_dimension_scale_factor=3, use_multi_channel_gainmap=False,
        preset=jax_types.EncPreset.REALTIME).encode_api0(
            benchmarks.photo_p010(136, 72), 92),
    "subsampled 3-channel map": lambda: _subsampled_map(_file(2, True)),
    "4:1:1 base": lambda: _with_base(_file(4, False), Fmt.YUV411),
    "grayscale base": lambda: _with_base(_file(4, False), Fmt.YUV400),
}


@pytest.mark.parametrize("kind", REFUSED)
def test_decode_host_refuses_what_jax_refuses(kind):
    data = REFUSED[kind]()
    codes = []
    for fn, err in ((lambda: port.JpegR(device="cpu").decode_host(data),
                     port.UhdrError),
                    (lambda: jax_jpegr.JpegR().decode_host(data),
                     jax_errors.UhdrError)):
        with pytest.raises(err) as e:
            fn()
        codes.append(int(e.value.code))
    assert codes == [UNSUPPORTED] * 2
    # the general path takes each of them but 4:1:1, which has no HDR
    # output on either package's general path
    if kind != "4:1:1 base":
        port.JpegR(device="cpu").decode(data, CT.HLG)


def test_decode_host_refuses_srgb_and_a_missing_map():
    data = _file(4, False)
    codes = []
    for fn, err in (
            (lambda: port.JpegR(device="cpu").decode_host(data, CT.SRGB),
             port.UhdrError),
            (lambda: jax_jpegr.JpegR().decode_host(
                data, jax_types.ColorTransfer.SRGB), jax_errors.UhdrError)):
        with pytest.raises(err) as e:
            fn()
        codes.append(int(e.value.code))
    assert codes == [UNSUPPORTED] * 2
    primary, _ = port.JpegR.extract_primary_and_gainmap(data)
    with pytest.raises(port.UhdrError) as e:
        port.JpegR(device="cpu").decode_host(primary)
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_ERROR


def _decoder(data, ct, fmt):
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(data)
    dec.set_out_color_transfer(ct)
    dec.set_out_img_format(fmt)
    return dec


def test_host_engine_through_the_decoder(monkeypatch):
    monkeypatch.setenv("UHDR_TPU_DECODE_ENGINE", "host")
    data = _file(4, False)
    dec = _decoder(data, CT.LINEAR, Fmt.RGBAF16)
    img = dec.decode()
    want, _, wgm = port.JpegR(device="cpu").decode_host(
        data, CT.LINEAR, return_gainmap=True)
    np.testing.assert_array_equal(img.planes[0], want.planes[0])
    np.testing.assert_array_equal(dec.get_decoded_gainmap_image().planes[0],
                                  wgm.planes[0])
    jdec = jax_api.UhdrDecoder()
    jdec.set_image(data)
    jdec.set_out_color_transfer(jax_types.ColorTransfer.LINEAR)
    jdec.set_out_img_format(jax_types.ImgFmt.RGBAF16)
    np.testing.assert_array_equal(img.planes[0],
                                  np.asarray(jdec.decode().planes[0]))
    # pinned to the host, a stream it refuses raises; no other engine runs
    refused = REFUSED["progressive base"]()
    with pytest.raises(port.UhdrError) as e:
        _decoder(refused, CT.HLG, Fmt.RGBA1010102).decode()
    assert int(e.value.code) == UNSUPPORTED
    jdec = jax_api.UhdrDecoder()
    jdec.set_image(refused)
    with pytest.raises(jax_errors.UhdrError) as e:
        jdec.decode()
    assert int(e.value.code) == UNSUPPORTED
    # SRGB: JpegR.decode on the host engine, the JAX decoder's bytes
    srgb = _decoder(data, CT.SRGB, Fmt.RGBA8888).decode()
    np.testing.assert_array_equal(
        srgb.planes[0], port.JpegR(device="cpu").decode(
            data, CT.SRGB, engine="host")[0].planes[0])
    jdec = jax_api.UhdrDecoder()
    jdec.set_image(data)
    jdec.set_out_color_transfer(jax_types.ColorTransfer.SRGB)
    jdec.set_out_img_format(jax_types.ImgFmt.RGBA8888)
    np.testing.assert_array_equal(srgb.planes[0],
                                  np.asarray(jdec.decode().planes[0]))


def test_native_build_is_keyed_by_the_host():
    """The host library is built with -march=native, so its key holds the
    compiler's view of the host: a host with other instruction sets builds
    its own library instead of loading this one."""
    name, srcs, command, key = port_native.build_args()
    assert "-march=native" in command and len(key) == 64
    path = buildlib.library_path(name, srcs, command, key)
    assert port_native.get_lib()._name == str(path)
    assert buildlib.library_path(name, srcs, command, "another host") != path
