"""PyTorch port: the public API modules against the JAX package.

- ``jpegr_compat.JpegRCompat(device="cpu")``: the status codes of the JAX
  ``JpegRCompat`` on every mutation of JAX ``tests/test_jpegr_compat.py``
  and more (bad strides, transfer, destination, knobs, decode arguments);
  the legacy encode's bytes equal the port's ``JpegR.encode_api0`` /
  ``encode_api1`` with the Android knobs, whatever the strides; the decode
  and info round trip within ``testing.check_decoded_close`` of the JAX
  compat's on the same file, the info, metadata and gain map equal.
- ``cli.main(["--device", "cpu", ...])``: its encode and decode outputs
  equal the port API's; the ``-P`` probe lines and the ``-f`` metadata cfg
  text equal the JAX CLI's; the ``-e`` PSNR line within 0.5 dB of it.
- ``capi_bridge``: ``_plane_geometry`` equal to JAX's for every format; an
  encode and decode round trip from ``ndarray.ctypes.data`` addresses of
  strided planes equal to ``UhdrEncoder`` / ``UhdrDecoder(device="cpu")``;
  ``error_tuple`` codes and the flat metadata equal to JAX's.
- ``utils.stage``: a no-op when disabled; enabled, a port encode (single
  and pipelined) records both ``encode.fetch_*`` stages.
- The port's top-level names are a superset of the JAX ``__init__``'s,
  and each subpackage re-exports what the JAX package's of the same name
  does (``from libultrahdr_tpu_torch.jpeg import JpegEncoder``; the API
  module's ``is_uhdr_image``); every JAX module, binding source and tool
  has a port counterpart, and every JAX test file the port's test files
  that hold its cases (``TEST_FILES``) or a named exclusion; every new
  entry point defaults to the card and raises without a GPU.
"""

import dataclasses
import importlib
import pathlib
import types as pytypes

import numpy as np
import pytest
import torch

import libultrahdr_tpu as jax_pkg
from libultrahdr_tpu import capi_bridge as jax_bridge
from libultrahdr_tpu import cli as jax_cli
from libultrahdr_tpu import jpegr_compat as jax_compat
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.errors import UhdrError as JaxUhdrError

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import capi_bridge, cli, fused, jpegr_compat
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.utils import profiling

from test_torch_jax_native import guard_jax_native

guard_jax_native()

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H = 64, 48
# the JAX package's subpackages, each with an __init__ that re-exports
SUBPACKAGES = ("jpeg", "ops", "container", "parallel", "utils")
Fmt, CG, CT = port.ImgFmt, port.ColorGamut, port.ColorTransfer

# the legacy surface's Android defaults (jpegr.h:28-43)
ANDROID = dict(map_dimension_scale_factor=4, map_compress_quality=85,
               use_multi_channel_gainmap=False, gamma=1.0,
               preset=port.EncPreset.REALTIME)


def _p010_arrays(seed=3):
    rng = np.random.default_rng(seed)
    y = (rng.integers(64, 940, (H, W), np.uint16) << 6).astype(np.uint16)
    uv = (rng.integers(64, 960, (H // 2, W), np.uint16) << 6).astype(
        np.uint16)
    return y, uv


def _legacy_p010(mod, y, uv, luma_stride=0, separate_chroma=False):
    """A legacy flat P010 struct of `mod` (JAX or port compat)."""
    img = mod.JpegRUncompressed(width=W, height=H,
                                color_gamut=mod.UltrahdrColorGamut.BT2100)
    ls = luma_stride or W
    if separate_chroma:
        ybuf = np.zeros(ls * H, np.uint16)
        ybuf.reshape(H, ls)[:, :W] = y
        cbuf = np.zeros(ls * (H // 2), np.uint16)
        cbuf.reshape(H // 2, ls)[:, :W] = uv
        img.data, img.chroma_data = ybuf, cbuf
        img.luma_stride = img.chroma_stride = ls
    else:
        buf = np.zeros(ls * H + ls * (H // 2), np.uint16)
        buf[:ls * H].reshape(H, ls)[:, :W] = y
        buf[ls * H:].reshape(H // 2, ls)[:, :W] = uv
        img.data = buf
        img.luma_stride = ls
    return img


def _dest(mod, n=1 << 20):
    return mod.JpegRCompressed(data=bytearray(n), max_length=n)


def _port_p010(y, uv):
    return port.RawImage(Fmt.P010, CG.BT2100, CT.HLG, port.ColorRange.LIMITED,
                         W, H, [y, uv])


# ---------------------------------------------------------------------------
# jpegr_compat

# name -> (mutation of the legacy image, compat keywords, transfer, dest)
COMPAT_CASES = {
    "ok": (None, {}, "HLG", None),
    "null_data": (lambda i: setattr(i, "data", None), {}, "HLG", None),
    "odd_width": (lambda i: setattr(i, "width", W - 1), {}, "HLG", None),
    "tiny_width": (lambda i: setattr(i, "width", 4), {}, "HLG", None),
    "huge_height": (lambda i: setattr(i, "height", 1 << 16), {}, "HLG",
                    None),
    "unspecified_gamut": (lambda i: setattr(i, "color_gamut", -1), {},
                          "HLG", None),
    "short_luma_stride": (lambda i: setattr(i, "luma_stride", W - 2), {},
                          "HLG", None),
    "short_chroma_stride": (lambda i: (setattr(i, "chroma_data",
                                               np.zeros(W * H, np.uint16)),
                                       setattr(i, "chroma_stride", W - 2)),
                            {}, "HLG", None),
    "srgb_transfer": (None, {}, "SRGB", None),
    "tiny_dest": (None, {}, "HLG", 16),
    "null_dest": (None, {}, "HLG", 0),
    "scale_0": (None, {"map_dimension_scale_factor": 0}, "HLG", None),
    "map_quality_101": (None, {"map_compress_quality": 101}, "HLG", None),
    "gamma_nan": (None, {"gamma": float("nan")}, "HLG", None),
    "bad_preset": (None, {"preset": 7}, "HLG", None),
    "boosts_swapped": (None, {"min_content_boost": 4.0,
                              "max_content_boost": 2.0}, "HLG", None),
    "target_nits_100": (None, {"target_disp_peak_brightness": 100.0}, "HLG",
                        None),
}


@pytest.mark.parametrize("case", list(COMPAT_CASES))
def test_compat_encode_status_matches_jax(case):
    mutate, kw, tf, dest_n = COMPAT_CASES[case]
    y, uv = _p010_arrays()
    status = []
    for mod, extra in ((jax_compat, {}), (jpegr_compat, {"device": "cpu"})):
        img = _legacy_p010(mod, y, uv)
        if mutate:
            mutate(img)
        dest = _dest(mod) if dest_n is None else (
            mod.JpegRCompressed(data=bytearray(dest_n), max_length=dest_n)
            if dest_n else mod.JpegRCompressed())
        if mod is jpegr_compat or case != "ok":
            st = mod.JpegRCompat(**kw, **extra).encode_api0(
                img, getattr(mod.UltrahdrTransferFunction, tf), dest)
            status.append(int(st))
    if case == "ok":
        # the JAX legacy encode equals the JAX JpegR's (its own test), the
        # port's equals the port JpegR's
        assert status == [int(jpegr_compat.Status.JPEGR_NO_ERROR)]
        assert bytes(dest.data[:dest.length]) == port.JpegR(
            device="cpu", **ANDROID).encode_api0(_port_p010(y, uv), 95)
        assert dest.color_gamut == jpegr_compat.UltrahdrColorGamut.P3
        return
    assert status[0] == status[1], (case, status)
    assert status[1] != int(jpegr_compat.Status.JPEGR_NO_ERROR)


def test_compat_stride_invariance():
    y, uv = _p010_arrays()
    want = port.JpegR(device="cpu", **ANDROID).encode_api0(_port_p010(y, uv),
                                                           95)
    for kw in ({"luma_stride": W + 16}, {"separate_chroma": True},
               {"luma_stride": W + 8, "separate_chroma": True}):
        dest = _dest(jpegr_compat)
        st = jpegr_compat.JpegRCompat(device="cpu").encode_api0(
            _legacy_p010(jpegr_compat, y, uv, **kw),
            jpegr_compat.UltrahdrTransferFunction.HLG, dest)
        assert st == jpegr_compat.Status.JPEGR_NO_ERROR, kw
        assert bytes(dest.data[:dest.length]) == want, kw


def test_compat_api1_and_api4():
    y, uv = _p010_arrays()
    jr = port.JpegR(device="cpu", **ANDROID)
    hdr = _port_p010(y, uv)
    sdr = jr.tone_map(hdr)
    status = {}
    for mod, extra in ((jax_compat, {}), (jpegr_compat, {"device": "cpu"})):
        sdr420 = mod.JpegRUncompressed(
            width=W, height=H, color_gamut=mod.UltrahdrColorGamut.P3,
            data=np.concatenate([p.reshape(-1) for p in sdr.planes]))
        c = mod.JpegRCompat(**extra)
        tf = mod.UltrahdrTransferFunction.HLG
        if mod is jpegr_compat:
            dest = _dest(mod)
            assert c.encode_api1(_legacy_p010(mod, y, uv), sdr420, tf,
                                 dest) == mod.Status.JPEGR_NO_ERROR
            assert bytes(dest.data[:dest.length]) == jr.encode_api1(hdr, sdr,
                                                                    95)
            blob = bytes(dest.data[:dest.length])
        sdr420.width = W - 2
        status[mod] = int(c.encode_api1(_legacy_p010(mod, y, uv), sdr420, tf,
                                        _dest(mod)))
    assert status[jax_compat] == status[jpegr_compat] == \
        int(jpegr_compat.Status.ERROR_JPEGR_RESOLUTION_MISMATCH)
    primary, gm, md = testing.read_jpegr(blob)
    legacy_md = jpegr_compat.UltrahdrMetadata(
        max_content_boost=float(md.max_content_boost[0]),
        min_content_boost=float(md.min_content_boost[0]),
        hdr_capacity_min=float(md.hdr_capacity_min),
        hdr_capacity_max=float(md.hdr_capacity_max))
    dest = _dest(jpegr_compat)
    st = jpegr_compat.JpegRCompat(device="cpu").encode_api4(
        jpegr_compat.JpegRCompressed(
            data=bytearray(primary), length=len(primary),
            color_gamut=jpegr_compat.UltrahdrColorGamut.P3),
        jpegr_compat.JpegRCompressed(data=bytearray(gm), length=len(gm)),
        legacy_md, dest)
    assert st == jpegr_compat.Status.JPEGR_NO_ERROR
    assert port.is_uhdr_image(bytes(dest.data[:dest.length]))


@pytest.fixture(scope="module")
def legacy_blob():
    y, uv = _p010_arrays()
    return port.JpegR(device="cpu", **ANDROID).encode_api0(_port_p010(y, uv),
                                                           95)


@pytest.mark.parametrize("out", ["HDR_HLG", "HDR_PQ", "HDR_LINEAR", "SDR"])
def test_compat_decode_and_info_match_jax(legacy_blob, out):
    blob = legacy_blob
    res = {}
    for mod, extra in ((jax_compat, {}), (jpegr_compat, {"device": "cpu"})):
        cj = mod.JpegRCompressed(data=bytearray(blob), length=len(blob),
                                 max_length=len(blob))
        info = mod.JpegRInfo(primary_img_info=mod.JpegInfo(),
                             gainmap_img_info=mod.JpegInfo())
        c = mod.JpegRCompat(**extra)
        assert c.get_jpegr_info(cj, info) == mod.Status.JPEGR_NO_ERROR
        dest = mod.JpegRUncompressed(data=np.zeros(W * H * 2, np.uint32))
        gm = mod.JpegRUncompressed(data=np.zeros(W * H, np.uint8))
        md = mod.UltrahdrMetadata()
        exif = mod.JpegRExif(data=bytearray(64), length=64)
        st = c.decode_jpegr(cj, dest, exif=exif,
                            output_format=getattr(mod.UltrahdrOutputFormat,
                                                  out),
                            gainmap_image=gm, metadata=md)
        assert st == mod.Status.JPEGR_NO_ERROR
        res[mod] = (info, dest, gm, md, exif)
    (ji, jd, jg, jm, je), (pi, pd, pg, pm, pe) = res[jax_compat], \
        res[jpegr_compat]
    assert (pi.width, pi.height) == (ji.width, ji.height) == (W, H)
    for slot in ("primary_img_info", "gainmap_img_info"):
        assert dataclasses.asdict(getattr(pi, slot)) == \
            dataclasses.asdict(getattr(ji, slot))
    assert (pd.width, pd.height, int(pd.pixel_format), int(pd.color_gamut),
            int(pd.color_range)) == (jd.width, jd.height, int(jd.pixel_format),
                                     int(jd.color_gamut), int(jd.color_range))
    assert dataclasses.asdict(pm) == dataclasses.asdict(jm)
    assert (pg.width, pg.height, int(pg.pixel_format)) == \
        (jg.width, jg.height, int(jg.pixel_format))
    np.testing.assert_array_equal(pg.data, jg.data)
    assert pe.length == je.length
    n = W * H * (2 if out == "HDR_LINEAR" else 1)
    a, b = pd.data[:n], jd.data[:n]
    if out == "SDR":
        np.testing.assert_array_equal(a, b)
    elif out == "HDR_LINEAR":
        testing.check_decoded_close(a.view(np.uint16).reshape(H, W, 4),
                                    b.view(np.uint16).reshape(H, W, 4),
                                    CT.LINEAR, out)
    else:
        testing.check_decoded_close(a.reshape(H, W), b.reshape(H, W),
                                    CT.HLG if out == "HDR_HLG" else CT.PQ,
                                    out)


def test_compat_decode_validation_matches_jax(legacy_blob):
    blob = legacy_blob
    status = {}
    for mod, extra in ((jax_compat, {}), (jpegr_compat, {"device": "cpu"})):
        cj = mod.JpegRCompressed(data=bytearray(blob), length=len(blob),
                                 max_length=len(blob))
        dest = mod.JpegRUncompressed(data=np.zeros(W * H * 2, np.uint32))
        c = mod.JpegRCompat(**extra)
        garbage = mod.JpegRCompressed(data=bytearray(b"nope"), length=4,
                                      max_length=4)
        status[mod] = [int(s) for s in (
            c.decode_jpegr(cj, dest, max_display_boost=0.5),
            c.decode_jpegr(cj, dest, output_format=-1),
            c.decode_jpegr(cj, mod.JpegRUncompressed()),
            c.decode_jpegr(cj, mod.JpegRUncompressed(
                data=np.zeros(4, np.uint32))),
            c.decode_jpegr(garbage, dest),
            c.decode_jpegr(cj, dest, exif=mod.JpegRExif()),
            c.decode_jpegr(cj, dest, exif=mod.JpegRExif(
                data=bytearray(0), length=0)),
            c.decode_jpegr(cj, dest, gainmap_image=mod.JpegRUncompressed()),
            c.decode_jpegr(cj, dest, gainmap_image=mod.JpegRUncompressed(
                data=np.zeros(4, np.uint8))),
            c.get_jpegr_info(garbage, mod.JpegRInfo()),
            c.get_jpegr_info(cj, None))]
    S = jpegr_compat.Status
    assert status[jpegr_compat] == status[jax_compat]
    assert status[jpegr_compat][:5] == [
        S.ERROR_JPEGR_INVALID_DISPLAY_BOOST,
        S.ERROR_JPEGR_INVALID_OUTPUT_FORMAT, S.ERROR_JPEGR_BAD_PTR,
        S.ERROR_JPEGR_BUFFER_TOO_SMALL, S.JPEGR_UNKNOWN_ERROR]


# ---------------------------------------------------------------------------
# cli

@pytest.fixture(scope="module")
def raw_p010(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    img = testing.photo_p010(W, H)
    path = d / "in.p010"
    with open(path, "wb") as f:
        for p in img.planes[:2]:
            f.write(np.ascontiguousarray(p, np.uint16).tobytes())
    return d, path


def _encode_args(path, out, device=("--device", "cpu")):
    return [*device, "-m", "0", "-p", str(path), "-w", str(W), "-h", str(H),
            "-a", "0", "-C", "2", "-t", "1", "-R", "1", "-s", "2", "-M", "0",
            "-q", "90", "-Q", "85", "-D", "0", "-z", str(out)]


def test_cli_encode_and_decode_equal_the_api(raw_p010, capsys):
    d, path = raw_p010
    out = d / "port.jpg"
    assert cli.main(_encode_args(path, out)) == 0
    got = out.read_bytes()
    enc = port.UhdrEncoder(device="cpu")
    enc.set_raw_image(port.RawImage(
        Fmt.P010, CG.BT2100, CT.HLG, port.ColorRange.FULL, W, H,
        [np.asarray(p, np.uint16) for p in testing.photo_p010(W, H).planes[:2]
         ]), port.ImgLabel.HDR)
    enc.set_quality(90, port.ImgLabel.BASE)
    enc.set_quality(85, port.ImgLabel.GAIN_MAP)
    enc.set_gainmap_scale_factor(2)
    enc.set_using_multi_channel_gainmap(False)
    enc.set_preset(port.EncPreset.REALTIME)
    assert got == enc.encode()
    for o, fmt, ct in ((1, Fmt.RGBA1010102, CT.HLG),
                       (0, Fmt.RGBAF16, CT.LINEAR),
                       (3, Fmt.RGBA8888, CT.SRGB)):
        raw = d / f"out{o}.raw"
        assert cli.main(["--device", "cpu", "-m", "1", "-j", str(out),
                         "-o", str(o), "-O", str(int(fmt)), "-z",
                         str(raw)]) == 0
        dec = port.UhdrDecoder(device="cpu")
        dec.set_image(got)
        dec.set_out_img_format(fmt)
        dec.set_out_color_transfer(ct)
        want = dec.decode()
        assert raw.read_bytes() == np.ascontiguousarray(
            want.planes[0]).tobytes()
    capsys.readouterr()


def test_cli_probe_and_metadata_cfg_equal_jax(raw_p010, capsys):
    d, path = raw_p010
    out = d / "probe.jpg"
    assert cli.main(_encode_args(path, out)) == 0
    capsys.readouterr()
    texts = []
    for main, tag in ((cli.main, "port"), (jax_cli.main, "jax")):
        extra = ["--device", "cpu"] if main is cli.main else []
        assert main([*extra, "-P", "-j", str(out)]) == 0
        probe = capsys.readouterr().out
        cfg = d / f"{tag}.cfg"
        assert main([*extra, "-m", "1", "-j", str(out), "-o", "1", "-O", "5",
                     "-z", str(d / f"{tag}.raw"), "-f", str(cfg)]) == 0
        capsys.readouterr()
        texts.append((probe, cfg.read_text()))
    assert texts[0] == texts[1]
    assert texts[0][0].startswith("Ultra HDR Image: Yes\n")
    not_uhdr = d / "plain.jpg"
    not_uhdr.write_bytes(testing.read_jpegr(out.read_bytes())[0])
    assert cli.main(["--device", "cpu", "-P", "-j", str(not_uhdr)]) == 1
    assert capsys.readouterr().out == "Not an ultra hdr image\n"


def test_cli_psnr_line_close_to_jax(raw_p010, capsys):
    d, path = raw_p010
    lines = []
    for main in (cli.main, jax_cli.main):
        device = ("--device", "cpu") if main is cli.main else ()
        assert main([*_encode_args(path, d / "e.jpg", device), "-e", "1"]) \
            == 0
        lines.append(capsys.readouterr().out.splitlines()[-1])
    vals = [[float(v) for v in ln.split(":")[1].split()] for ln in lines]
    assert all(ln.startswith("PSNR rgb: ") for ln in lines)
    np.testing.assert_allclose(vals[0], vals[1], atol=0.5)
    assert min(vals[0]) > 30.0


# ---------------------------------------------------------------------------
# capi_bridge

@pytest.mark.parametrize("fmt", list(port.ImgFmt))
def test_plane_geometry_matches_jax(fmt):
    try:
        want = jax_bridge._plane_geometry(int(fmt), 38, 22)
    except JaxUhdrError as e:
        with pytest.raises(port.UhdrError) as pe:
            capi_bridge._plane_geometry(fmt, 38, 22)
        assert int(pe.value.code) == int(e.code)
        return
    assert capi_bridge._plane_geometry(fmt, 38, 22) == want


def test_bridge_round_trip_from_addresses():
    """Strided C planes in, through the bridge's encoder and decoder, equal
    to the port API on the same image."""
    img = testing.photo_p010(W, H)
    y, uv = (np.asarray(p, np.uint16) for p in img.planes[:2])
    stride = W + 24
    bufs = [np.zeros((H, stride), np.uint16),
            np.zeros((H // 2, stride), np.uint16)]
    bufs[0][:, :W], bufs[1][:, :W] = y, uv
    enc = capi_bridge.enc_new("cpu")
    capi_bridge.enc_set_raw_image(
        enc, int(Fmt.P010), int(CG.BT2100), int(CT.HLG),
        int(port.ColorRange.FULL), W, H, [b.ctypes.data for b in bufs],
        [stride, stride], int(port.ImgLabel.HDR))
    enc.set_gainmap_scale_factor(4)
    enc.encode()
    got = capi_bridge.enc_get_stream(enc)
    ref = port.UhdrEncoder(device="cpu")
    ref.set_raw_image(port.RawImage(Fmt.P010, CG.BT2100, CT.HLG,
                                    port.ColorRange.FULL, W, H, [y, uv]),
                      port.ImgLabel.HDR)
    ref.set_gainmap_scale_factor(4)
    assert got == ref.encode()
    assert capi_bridge.is_uhdr_image(got)

    dec = capi_bridge.dec_new("cpu")
    capi_bridge.dec_set_image(dec, got)
    dec.set_out_img_format(Fmt.RGBA1010102)
    dec.set_out_color_transfer(CT.HLG)
    dec.decode()
    pdec = port.UhdrDecoder(device="cpu")
    pdec.set_image(got)
    pdec.set_out_img_format(Fmt.RGBA1010102)
    pdec.set_out_color_transfer(CT.HLG)
    want = pdec.decode()
    fmt, cg, ct, rng, w, h, planes, strides = \
        capi_bridge.dec_get_decoded_image(dec)
    assert (fmt, ct, w, h, strides) == (int(Fmt.RGBA1010102), int(CT.HLG), W,
                                        H, (W,))
    assert planes[0] == want.planes[0].tobytes()
    gfmt, *_, gplanes, gstrides = capi_bridge.dec_get_gainmap_image_raw(dec)
    assert gplanes[0] == pdec.get_decoded_gainmap_image().planes[0].tobytes()
    flat = capi_bridge.dec_get_gainmap_metadata_flat(dec)
    assert flat == capi_bridge.meta_to_flat(pdec.get_gainmap_metadata())
    md = capi_bridge._meta_from_flat(flat)
    assert capi_bridge.meta_to_flat(md) == flat
    jmd = jax_bridge._meta_from_flat(flat)
    assert jax_bridge.meta_to_flat(jmd) == flat
    # API-4 through the bridge: the compressed parts back in
    enc4 = capi_bridge.enc_new("cpu")
    capi_bridge.enc_set_compressed_image(
        enc4, pdec.get_base_image(), int(CG.DISPLAY_P3), int(CT.SRGB),
        int(port.ColorRange.FULL), int(port.ImgLabel.BASE))
    capi_bridge.enc_set_gainmap_image(
        enc4, pdec.get_gainmap_image(), int(CG.UNSPECIFIED),
        int(CT.UNSPECIFIED), int(port.ColorRange.FULL), flat)
    enc4.encode()
    assert capi_bridge.is_uhdr_image(capi_bridge.enc_get_stream(enc4))
    assert capi_bridge.dec_get_decoded_image(capi_bridge.dec_new("cpu")) \
        is None


def test_bridge_refusals_and_error_tuples_match_jax():
    with pytest.raises(port.UhdrError) as e:
        capi_bridge._read_planes(Fmt.P010, W, H, [0, 1], [0, 0])
    with pytest.raises(JaxUhdrError) as je:
        jax_bridge._read_planes(int(Fmt.P010), W, H, [0, 1], [0, 0])
    assert capi_bridge.error_tuple(e.value) == jax_bridge.error_tuple(
        je.value)
    buf = np.zeros(W * H, np.uint16)
    with pytest.raises(port.UhdrError) as e:
        capi_bridge._read_planes(Fmt.P010, W, H, [buf.ctypes.data] * 2,
                                 [W - 1, W])
    with pytest.raises(JaxUhdrError) as je:
        jax_bridge._read_planes(int(Fmt.P010), W, H, [buf.ctypes.data] * 2,
                                [W - 1, W])
    assert capi_bridge.error_tuple(e.value) == jax_bridge.error_tuple(
        je.value)
    for exc_p, exc_j in (
            (port.UhdrError(port.UhdrErrorCode.UHDR_CODEC_INVALID_OPERATION,
                            "x"),
             JaxUhdrError(jax_pkg.UhdrErrorCode.UHDR_CODEC_INVALID_OPERATION,
                          "x")),
            (ValueError("v"), ValueError("v")),
            (RuntimeError("r"), RuntimeError("r"))):
        assert capi_bridge.error_tuple(exc_p)[0] == \
            jax_bridge.error_tuple(exc_j)[0]


# ---------------------------------------------------------------------------
# utils.stage

def test_stage_timers():
    """stage() records only under torch.profiler, and stage_report() sums
    what it recorded: a fused encode its chain of spans
    (tests/test_torch_encode_trace.py), the pipelined encode each image's
    upload, joins and container, and three ``decode.parse`` spans three
    calls (the decode chain: tests/test_torch_trace.py)."""
    def calls():
        return {k: n for k, (n, _) in profiling.stage_report().items()}
    profiling.clear()
    with profiling.stage("decode.parse"):
        pass
    assert profiling.stage_report() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        enc = port.UhdrEncoder(device="cpu")
        enc.set_raw_image(testing.photo_p010(W, H), port.ImgLabel.HDR)
        enc.encode()
        assert calls() == {"encode": 1, "encode.upload": 1,
                           "encode.dispatch": 2, "encode.download": 1,
                           "encode.join": 1, "encode.assemble": 1}
        profiling.clear()
        fused.encode_api0_p010_pipelined(
            port.JpegR(device="cpu"), [testing.photo_p010(W, H, seed=s)
                                       for s in (1, 2)])
        assert calls() == {"encode.upload": 2, "encode.join": 4,
                           "encode.assemble": 2}
        profiling.clear()
        for _ in range(3):
            with profiling.stage("decode.parse"):
                pass
    rep = profiling.stage_report()
    assert list(rep) == ["decode.parse"] and rep["decode.parse"][0] == 3
    assert rep["decode.parse"][1] >= 0.0
    profiling.clear()


# ---------------------------------------------------------------------------
# the package surface

def test_public_names_superset_of_jax():
    """The port's top-level names are a superset of the JAX package's, and
    what each subpackage of the JAX package re-exports (``from
    libultrahdr_tpu.jpeg import JpegEncoder``) the port's subpackage of the
    same name re-exports too, bound to the port's own objects.  Modules,
    and the names ``test_torch_surface.EXCLUDED`` gives a reason for under
    any module of the subpackage, are not compared."""
    from test_torch_surface import EXCLUDED
    names = {n for n, v in vars(jax_pkg).items()
             if not n.startswith("_") and not isinstance(v, pytypes.ModuleType)}
    missing = names - set(dir(port))
    assert not missing, missing
    for sub in SUBPACKAGES:
        jmod = importlib.import_module(f"libultrahdr_tpu.{sub}")
        pmod = importlib.import_module(f"libultrahdr_tpu_torch.{sub}")
        excluded = {n for rel, ex in EXCLUDED.items()
                    if rel.startswith(f"{sub}/") for n in ex}
        names = {n for n, v in vars(jmod).items()
                 if not n.startswith("_")
                 and not isinstance(v, pytypes.ModuleType)} - excluded
        missing = names - set(dir(pmod))
        assert not missing, (sub, sorted(missing))
        for n in names:
            mod = getattr(getattr(pmod, n), "__module__", "")
            assert mod.startswith("libultrahdr_tpu_torch"), (sub, n, mod)
    for n in ("MirrorDirection", "alloc_raw_image",
              "validate_gainmap_metadata"):
        assert getattr(port, n).__module__.startswith("libultrahdr_tpu_torch")
    img = port.alloc_raw_image(Fmt.P010, CG.BT2100, CT.HLG,
                               port.ColorRange.FULL, 16, 8)
    jimg = jax_types.alloc_raw_image(int(Fmt.P010), int(CG.BT2100),
                                     int(CT.HLG), 1, 16, 8)
    assert [p.shape for p in img.planes] == [p.shape for p in jimg.planes]


def test_api_reexports_is_uhdr_image():
    """``libultrahdr_tpu.api`` re-exports ``is_uhdr_image`` on purpose; so
    does the port's, and it is the port's probe."""
    assert "is_uhdr_image" in vars(jax_pkg.api)
    from libultrahdr_tpu_torch.api import is_uhdr_image
    assert is_uhdr_image is port.jpegr.is_uhdr_image
    data = port.JpegR(device="cpu").encode_api0(testing.photo_p010(W, H))
    assert is_uhdr_image(data) and not is_uhdr_image(data[:2] + b"\xff\xd9")


# JAX modules the port holds under another name
PORTED_AS = {"ops/pallas_apply.py": "ops/apply_kernel.py"}


# the JAX repository's hardening tools and their port counterparts
HARDENING_TOOLS = {"fuzz/fuzz_parsers.py": "fuzz/fuzz_parsers.py",
                   "fuzz/differential.py": "fuzz/differential.py",
                   "tools/sanitize_replay.py": "tools/sanitize_replay.py",
                   "tools/_capi_asan_smoke.c": "tools/capi_asan_smoke.c",
                   "tools/full_gate.py": "tools/full_gate.py"}
# the JAX repository's profile and benchmark tools the port has a
# counterpart of
PROFILE_TOOLS = {"tools/profile_encode_pipeline.py":
                 "tools/profile_encode_pipeline.py",
                 "bench.py": "tools/bench.py",
                 "benchmarks.py": "tools/benchmarks.py",
                 "tools/derive_islow.py": "tools/derive_islow.py"}


def test_module_coverage():
    """Every .py module of the JAX package has a port module of the same
    name (or the one PORTED_AS names), every C, C++, header and Java
    source of its bindings (``capi/``, ``java/``) a counterpart of the same
    name under the port's ``capi/`` and ``java/``, and the hardening tools
    (the guided fuzzer, the differential fuzzer, the sanitizer replay and
    its C smoke, the segmented test gate), the profile tools (the pipelined encode's wire profile),
    the benchmark scripts (``bench.py``, ``benchmarks.py``) and the islow
    derivation (``tools/derive_islow.py``) one under the port's ``fuzz/``
    and ``tools/``."""
    jax_root = REPO / "libultrahdr_tpu"
    port_root = REPO / "libultrahdr_tpu_torch"
    unported = []
    for f in sorted(jax_root.rglob("*.py")):
        rel = f.relative_to(jax_root).as_posix()
        if not (port_root / PORTED_AS.get(rel, rel)).is_file():
            unported.append(rel)
    bindings = [f.relative_to(REPO).as_posix()
                for d in ("capi", "java") for f in sorted((REPO / d).rglob("*"))
                if f.suffix in (".h", ".c", ".cpp", ".java")]
    assert len(bindings) == 9
    unported += [rel for rel in bindings if not (port_root / rel).is_file()]
    tools = {**HARDENING_TOOLS, **PROFILE_TOOLS}
    assert all((REPO / rel).is_file() for rel in tools)
    unported += [rel for rel, port_rel in tools.items()
                 if not (port_root / port_rel).is_file()]
    assert unported == []
    assert all((port_root / p).is_file() for p in PORTED_AS.values())


# every test file of the JAX package (each pre-port tests/test_*.py) -> the
# port's test files that hold its cases
TEST_FILES = {
    "test_agtm.py": ["test_torch_agtm.py"],
    "test_api.py": ["test_torch_encode_general.py", "test_torch_decode.py",
                    "test_torch_effects.py"],
    "test_capi.py": ["test_torch_capi.py"],
    "test_colors.py": ["test_torch_golden_anchors.py", "test_torch_surface.py",
                       "test_torch_tables.py"],
    "test_container.py": ["test_torch_tables.py", "test_torch_container.py"],
    "test_decode_device_and_xmp.py": ["test_torch_decode_device_xmp.py",
                                      "test_torch_decode.py"],
    "test_decode_fused.py": ["test_torch_decode.py",
                             "test_torch_decode_batch.py"],
    "test_effects_device.py": ["test_torch_effects.py"],
    "test_fused.py": ["test_torch_encode.py", "test_torch_encode_general.py",
                      "test_torch_decode_batch.py"],
    "test_fused_variants.py": ["test_torch_fused_variants.py"],
    "test_fuzz.py": ["test_torch_fuzz.py"],
    "test_fuzz_differential.py": ["test_torch_fuzz_differential.py"],
    "test_fuzz_guided.py": ["test_torch_fuzz.py"],
    "test_golden_anchors.py": ["test_torch_golden_anchors.py"],
    "test_host_decode.py": ["test_torch_decode_host.py",
                            "test_torch_surface.py"],
    "test_java_binding.py": ["test_torch_java_binding.py"],
    "test_jpeg.py": ["test_torch_encode_general.py", "test_torch_decode.py",
                     "test_torch_surface.py"],
    "test_jpegr_compat.py": ["test_torch_api_surface.py"],
    "test_jpegr_e2e.py": ["test_torch_jpegr_e2e.py"],
    "test_ops.py": ["test_torch_ops.py", "test_torch_apply.py",
                    "test_torch_decode_general.py"],
    "test_pack_kernel.py": ["test_torch_pack.py", "test_torch_pack_slots.py"],
    "test_pallas_apply.py": ["test_torch_apply.py"],
    "test_parallel.py": ["test_torch_parallel.py"],
    "test_progressive.py": ["test_torch_decode_general.py"],
    "test_reference_fixtures.py": ["test_torch_reference_fixtures.py"],
    "test_reference_goldens.py": ["test_torch_reference_goldens.py"],
    "test_round3_fixes.py": ["test_torch_round3.py"],
    "test_sanitizers.py": ["test_torch_sanitizers.py"],
    "test_smoke_e2e.py": ["test_torch_smoke_e2e.py"],
    "test_wire_codec.py": ["test_torch_wire.py", "test_torch_wire_routes.py",
                           "test_torch_wire_kernel.py"],
}
# the JAX package's test files with no port counterpart, and why
TEST_FILES_EXCLUDED = {
    "test_reference_binary.py": "needs a build of the reference library "
                                "(the reference's own binary), which no "
                                "test machine has; the reference's files "
                                "are held by test_torch_reference_goldens.py",
    "test_device_entropy.py": "the XLA pack route, which test_torch_surface."
                              "EXCLUDED names; its kernel's counterpart is "
                              "held by test_torch_pack.py",
}


def test_test_file_coverage():
    """Every test file of the JAX package maps to the port's test files
    that hold its cases, or to a named exclusion with its reason; each
    port file named exists."""
    tests = REPO / "tests"
    jax_files = {f.name for f in tests.glob("test_*.py")
                 if not f.name.startswith("test_torch_")}
    assert sorted(jax_files - set(TEST_FILES) - set(TEST_FILES_EXCLUDED)) \
        == []
    assert sorted(set(TEST_FILES) | set(TEST_FILES_EXCLUDED)) == \
        sorted(jax_files)
    assert not set(TEST_FILES) & set(TEST_FILES_EXCLUDED)
    named = [f for fs in TEST_FILES.values() for f in fs] + [
        "test_torch_pack.py", "test_torch_reference_goldens.py"]
    assert all(f.startswith("test_torch_") and (tests / f).is_file()
               for f in named), named
    assert all(reason for reason in TEST_FILES_EXCLUDED.values())


def test_no_entry_point_defaults_to_the_cpu():
    """Every function of the port with a ``device`` parameter defaults to
    the card or to its caller's tensors (``"cuda"`` or None), and every
    command line's ``--device`` to ``"cuda"``: no entry point runs on the
    CPU unless asked."""
    import ast
    found = []
    for f in sorted((REPO / "libultrahdr_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                pairs = list(zip(a.args[len(a.args) - len(a.defaults):],
                                 a.defaults))
                pairs += [(k, d) for k, d in zip(a.kwonlyargs,
                                                 a.kw_defaults) if d]
                for arg, d in pairs:
                    if arg.arg == "device" and isinstance(d, ast.Constant):
                        found.append((f.name, node.name, d.value))
            elif isinstance(node, ast.Call) and node.args and isinstance(
                    node.args[0], ast.Constant) \
                    and node.args[0].value == "--device" \
                    and getattr(node.func, "attr", "") == "add_argument":
                d = {k.arg: k.value for k in node.keywords}.get("default")
                found.append((f.name, "--device",
                              getattr(d, "value", d)))
    assert found
    assert [x for x in found if x[2] not in ("cuda", None)] == []
    assert sum(x[1] == "--device" for x in found) >= 6


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """JpegRCompat, cli.main, capi_bridge.enc_new / dec_new and (in
    test_torch_agtm.py) generate_gainmap_agtm run on the card unless asked
    for the CPU: with no GPU each default raises, nothing runs elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "x.jpg"
    data.write_bytes(b"\xff\xd8\xff\xd9")
    for make in (jpegr_compat.JpegRCompat, capi_bridge.enc_new,
                 capi_bridge.dec_new,
                 lambda: cli.main(["-m", "1", "-j", str(data)]),
                 lambda: cli.main(["-m", "0", "-p", str(data), "-w", "16",
                                   "-h", "16"])):
        with pytest.raises(port.UhdrError) as e:
            make()
        assert e.value.code == \
            port.UhdrErrorCode.UHDR_CODEC_UNSUPPORTED_FEATURE
