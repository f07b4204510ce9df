"""PyTorch port: the effect queue and the device-resident effects against
the JAX package.

- ``ops/effects_device`` against the JAX ``ops/effects_device``, bit-exact,
  on a rectangular 96x64 packed output: RGBA1010102 as int32 carriers
  against uint32, RGBAF16 as (H, W, 4) int16 against uint16; every effect,
  the upscale quirk (a stride of 0 repeats row and column 0), a clamped
  crop, a chain, and the refusals of an empty crop and a resize to 0 with
  the same ``UhdrErrorCode``.  Every result owns its storage.
- ``decode_to_device(effects=...)`` on the per-image route and through the
  microbatcher equals the port's host ``editor`` on the output without
  effects, and the JAX package's device-resident effects within
  ``testing.check_decoded_close``.
- ``UhdrDecoder(device="cpu")`` with effects equals the port's ``editor``
  applied to the same decode without effects, image and gain map,
  bit-exact; it matches the JAX ``UhdrDecoder`` (on its device engine, the
  one the port's ``auto`` is) on dims and error codes, its output within
  ``check_decoded_close`` and its gain map equal.
- ``UhdrEncoder(device="cpu")`` with effects gives the file of the port's
  encode of the intent edited beforehand, byte for byte; against the JAX
  encoder with the same effects: the same geometry; coefficients within 1
  of the JAX file's, on at most 64e-3 of them (the u8 contract lets 1e-3
  of the samples differ by 1, which moves at most the 64 coefficients of
  their block, by at most 1/4 of a quantisation step, so by 1 after
  rounding); the file decoding in the JAX decoder at >= 60 dB against the
  JAX file; or, where the JAX encode fails, the same error code
  (``capi_bridge.error_tuple``).
- ``enable_gpu_acceleration(False)`` gives the bytes of ``use_fused=False``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import benchmarks
from libultrahdr_tpu import api as jax_api
from libultrahdr_tpu import capi_bridge as jax_bridge
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.errors import UhdrError as JaxUhdrError
from libultrahdr_tpu.ops import effects_device as jax_fx

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import api as port_api
from libultrahdr_tpu_torch import capi_bridge as port_bridge
from libultrahdr_tpu_torch import editor as port_editor
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg.decoder import parse_jpeg
from libultrahdr_tpu_torch.ops import effects_device as port_fx

W, H = 96, 64
Fmt, CT = port.ImgFmt, port.ColorTransfer
OUTPUTS = {"HLG": (CT.HLG, Fmt.RGBA1010102), "PQ": (CT.PQ, Fmt.RGBA1010102),
           "LINEAR": (CT.LINEAR, Fmt.RGBAF16), "SRGB": (CT.SRGB, Fmt.RGBA8888)}


def effects_of(api, spec):
    """The effect descriptors of `api` (the JAX or the port module) for a
    spec: ("mirror", dir) | ("rotate", deg) | ("crop", l, r, t, b) |
    ("resize", w, h)."""
    kinds = {"mirror": lambda d: api.MirrorEffect(api.MirrorDirection(d)),
             "rotate": api.RotateEffect, "crop": api.CropEffect,
             "resize": api.ResizeEffect}
    return [kinds[e[0]](*e[1:]) for e in spec]


def add_effects(ctx, spec):
    for e in spec:
        getattr(ctx, "add_effect_" + e[0])(*e[1:])


def owns_storage(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.storage_offset() == 0 and \
        t.untyped_storage().nbytes() == t.numel() * t.element_size()


def error_code(exc) -> int:
    """An exception as the C ABI reports it (UhdrError code, else
    UHDR_CODEC_UNKNOWN_ERROR), through the port's bridge."""
    return port_bridge.error_tuple(exc)[0]


# ---------------------------------------------------------------------------
# ops/effects_device, bit-exact

DEVICE_CASES = {
    "mirror_h": [("mirror", 1)],
    "mirror_v": [("mirror", 0)],
    "rot90": [("rotate", 90)],
    "rot180": [("rotate", 180)],
    "rot270": [("rotate", 270)],
    "crop": [("crop", 8, 72, 4, 60)],
    "crop_clamped": [("crop", -5, 200, 3, 900)],
    "resize_down": [("resize", 40, 25)],
    "resize_upscale_quirk": [("resize", 150, 70)],
    "chain": [("rotate", 90), ("mirror", 1), ("crop", 4, 52, 8, 88),
              ("resize", 20, 30), ("rotate", 180)],
    "invalid_crop": [("crop", 50, 40, 0, 10)],
    "invalid_crop_after_rotate": [("rotate", 90), ("crop", 0, 10, 70, 80)],
    "invalid_resize": [("resize", 0, 10)],
}


def _packed(kind, seed=7):
    rs = np.random.RandomState(seed)
    if kind == "1010102":
        return rs.randint(0, 2 ** 32, (H, W), dtype=np.uint64).astype(
            np.uint32)
    return rs.randint(0, 2 ** 16, (H, W, 4)).astype(np.uint16)


@pytest.mark.parametrize("kind", ["1010102", "f16"])
@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_effects_device_matches_jax(case, kind):
    spec = DEVICE_CASES[case]
    arr = _packed(kind)
    carrier = np.int32 if kind == "1010102" else np.int16
    try:
        want = jax_fx.apply_effects_packed(
            jnp.asarray(arr), effects_of(jax_api, spec), W, H)
    except JaxUhdrError as e:
        want = e
    try:
        got = port_fx.apply_effects_packed(
            torch.from_numpy(arr.view(carrier)), effects_of(port_api, spec))
    except port.UhdrError as e:
        got = e
    if isinstance(want, Exception):
        assert isinstance(got, port.UhdrError), got
        assert int(got.code) == int(want.code)
        return
    (wa, ww, wh), (ga, gw, gh) = want, got
    assert (gw, gh) == (ww, wh)
    assert ga.dtype == torch.from_numpy(np.zeros(1, carrier)).dtype
    np.testing.assert_array_equal(ga.numpy().view(arr.dtype), np.asarray(wa))
    assert owns_storage(ga)


def test_each_device_effect_owns_its_storage():
    """A rotation is not left a transposed view, a crop not a slice of the
    frame (whole rows, where a plain .contiguous() would keep the view)."""
    arr = torch.from_numpy(_packed("1010102").view(np.int32))
    for out in (port_fx.rotate_packed(arr, 90), port_fx.rotate_packed(arr, 270),
                port_fx.crop_packed(arr, 0, 10, W, 20),
                port_fx.crop_packed(arr, 3, 10, 20, 20),
                port_fx.mirror_packed(arr, port.MirrorDirection.VERTICAL),
                port_fx.resize_packed(arr, 30, 20)):
        assert owns_storage(out)
        assert out.untyped_storage().data_ptr() != \
            arr.untyped_storage().data_ptr()
    with pytest.raises(port.UhdrError):
        port_fx.rotate_packed(arr, 45)


# ---------------------------------------------------------------------------
# the decoder's effects


@functools.lru_cache(maxsize=None)
def _jax_file(scale, multichannel):
    return jax_jpegr.JpegR(
        map_dimension_scale_factor=scale,
        use_multi_channel_gainmap=multichannel).encode_api0(
            benchmarks.photo_p010(W, H), 95)


def _port_decoder(data, out, spec=(), gpu=True):
    ct, fmt = OUTPUTS[out]
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(data)
    dec.set_out_color_transfer(ct)
    dec.set_out_img_format(fmt)
    dec.enable_gpu_acceleration(gpu)
    add_effects(dec, spec)
    return dec


@functools.lru_cache(maxsize=None)
def _port_plain(data, out):
    dec = _port_decoder(data, out)
    return dec.decode(), dec.get_decoded_gainmap_image()


def _editor(img, spec):
    """The port's editor applied to a decoded image for a spec, with the
    coordinates the decoder gives `img` (already scaled for a gain map by
    the caller)."""
    for e in spec:
        if e[0] == "mirror":
            img = port_editor.apply_mirror(img, port.MirrorDirection(e[1]))
        elif e[0] == "rotate":
            img = port_editor.apply_rotate(img, e[1])
        elif e[0] == "crop":
            l, r, t, b = e[1:]
            img = port_editor.apply_crop(img, l, t, r - l, b - t)
        else:
            img = port_editor.apply_resize(img, *e[1:])
    return img


# name -> (scale, multichannel, output, effects, gain-map effects or the
# error the decode raises)
DECODER_CASES = {
    # JAX tests/test_api.py:201-243
    "rotate90_hlg": (2, False, "HLG", [("rotate", 90)], [("rotate", 90)]),
    "crop_srgb": (2, False, "SRGB", [("crop", 16, 80, 8, 40)],
                  [("crop", 8, 40, 4, 20)]),
    "resize_linear": (2, False, "LINEAR", [("resize", 64, 32)],
                      [("resize", 32, 16)]),
    # crop coordinates off the scale-4 grid: the map's are truncated
    "crop_off_grid_scale4_pq": (4, False, "PQ", [("crop", 5, 70, 3, 61)],
                                [("crop", 1, 17, 0, 15)]),
    "mirror_v_3ch_hlg": (1, True, "HLG", [("mirror", 0)], [("mirror", 0)]),
    "rotate270_crop_3ch_linear": (
        1, True, "LINEAR", [("rotate", 270), ("crop", 10, 50, 20, 90)],
        [("rotate", 270), ("crop", 10, 50, 20, 90)]),
    "upscale_quirk_hlg": (2, False, "HLG", [("resize", 120, 80)],
                          [("resize", 60, 40)]),
    "chain_linear": (4, False, "LINEAR",
                     [("mirror", 1), ("rotate", 90), ("crop", 8, 56, 12, 84),
                      ("resize", 24, 36)],
                     [("mirror", 1), ("rotate", 90), ("crop", 2, 14, 3, 21),
                      ("resize", 6, 9)]),
    "invalid_crop": (2, False, "HLG", [("crop", 40, 40, 0, 10)],
                     port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM),
    "invalid_gainmap_crop": (4, False, "HLG", [("crop", 0, 3, 0, 10)],
                             port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM),
    "invalid_resize": (2, False, "HLG", [("resize", 1, 64)],
                       port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM),
}


@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_decoder_effects(case, monkeypatch):
    scale, mc, out, spec, gm_spec = DECODER_CASES[case]
    data = _jax_file(scale, mc)
    dec = _port_decoder(data, out, spec)
    jdec = jax_api.UhdrDecoder()
    jdec.set_image(data)
    jdec.set_out_color_transfer(int(OUTPUTS[out][0]))
    jdec.set_out_img_format(int(OUTPUTS[out][1]))
    add_effects(jdec, spec)
    monkeypatch.setenv("UHDR_TPU_DECODE_ENGINE", "device")
    if not isinstance(gm_spec, list):
        with pytest.raises(port.UhdrError) as e:
            dec.decode()
        assert e.value.code == gm_spec
        with pytest.raises(JaxUhdrError) as je:
            jdec.decode()
        assert int(je.value.code) == int(gm_spec)
        return
    img, gm = dec.decode(), dec.get_decoded_gainmap_image()
    plain, plain_gm = _port_plain(data, out)
    want, want_gm = _editor(plain, spec), _editor(plain_gm, gm_spec)
    for a, b in ((img, want), (gm, want_gm)):
        assert (a.w, a.h, a.fmt) == (b.w, b.h, b.fmt)
        np.testing.assert_array_equal(a.planes[0], b.planes[0])
    jimg, jgm = jdec.decode(), jdec.get_decoded_gainmap_image()
    assert (img.w, img.h, int(img.fmt)) == (jimg.w, jimg.h, int(jimg.fmt))
    assert (gm.w, gm.h, int(gm.fmt)) == (jgm.w, jgm.h, int(jgm.fmt))
    np.testing.assert_array_equal(gm.planes[0], np.asarray(jgm.planes[0]))
    if out == "SRGB":
        np.testing.assert_array_equal(img.planes[0],
                                      np.asarray(jimg.planes[0]))
    else:
        testing.check_decoded_close(img.planes[0], np.asarray(jimg.planes[0]),
                                    OUTPUTS[out][0], case)


def test_resize_of_a_three_channel_map_fails_as_in_jax(monkeypatch):
    """The editor's effect resize takes 2-D planes, so a decode whose gain
    map is RGB888 fails on resize in both packages, the same way."""
    monkeypatch.setenv("UHDR_TPU_DECODE_ENGINE", "device")
    data = _jax_file(1, True)
    dec = _port_decoder(data, "HLG", [("resize", 48, 32)])
    jdec = jax_api.UhdrDecoder()
    jdec.set_image(data)
    jdec.set_out_color_transfer(int(CT.HLG))
    jdec.set_out_img_format(int(Fmt.RGBA1010102))
    jdec.add_effect_resize(48, 32)
    with pytest.raises(Exception) as e:
        dec.decode()
    with pytest.raises(Exception) as je:
        jdec.decode()
    assert type(e.value) is type(je.value)
    assert error_code(e.value) == jax_bridge.error_tuple(je.value)[0]


def test_effect_setters_validate_and_sail():
    """JAX tests/test_api.py:144 and the sailed check of every setter."""
    for ctx in (port.UhdrEncoder(device="cpu"), port.UhdrDecoder(device="cpu")):
        with pytest.raises(port.UhdrError) as e:
            ctx.add_effect_rotate(45)
        assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM
        with pytest.raises(port.UhdrError) as e:
            ctx.add_effect_mirror(7)
        assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM
        ctx.add_effect_rotate(270)
        ctx.add_effect_mirror(port.MirrorDirection.HORIZONTAL)
        ctx.add_effect_crop(0, 8, 0, 8)
        ctx.add_effect_resize(8, 8)
        ctx.enable_gpu_acceleration(False)
        assert len(ctx._effects) == 4
    dec = _port_decoder(_jax_file(2, False), "HLG", [("rotate", 180)])
    dec.decode()
    for call in (lambda: dec.add_effect_rotate(90),
                 lambda: dec.add_effect_mirror(0),
                 lambda: dec.add_effect_crop(0, 1, 0, 1),
                 lambda: dec.add_effect_resize(8, 8),
                 lambda: dec.enable_gpu_acceleration(True)):
        with pytest.raises(port.UhdrError) as e:
            call()
        assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_OPERATION
    dec.reset()
    assert dec._effects == []


# ---------------------------------------------------------------------------
# effects on the device-resident decode


@pytest.mark.parametrize("microbatch", [False, True])
@pytest.mark.parametrize("out,spec", [
    ("HLG", [("rotate", 90), ("mirror", 1), ("crop", 4, 52, 8, 88)]),
    ("LINEAR", [("rotate", 180), ("resize", 40, 30)]),
    ("PQ", [("crop", 0, W, 10, 30)]),
])
def test_decode_to_device_effects(out, spec, microbatch):
    data = _jax_file(2, False)
    jr = port.JpegR(device="cpu")
    ct = OUTPUTS[out][0]
    got, md = jr.decode_to_device(data, ct, effects=effects_of(port_api, spec),
                                  microbatch=microbatch)
    assert owns_storage(got)
    plain, _ = _port_plain(data, out)
    want = _editor(plain, spec).planes[0]
    np.testing.assert_array_equal(testing.host_packed(got), want)
    assert md.hdr_capacity_max > 1.0
    jgot, _ = jax_jpegr.JpegR().decode_to_device(
        data, int(ct), effects=effects_of(jax_api, spec), microbatch=False)
    testing.check_decoded_close(got, np.asarray(jgot), ct, out)


# ---------------------------------------------------------------------------
# the encoder's effects


def _to_port(img):
    return port.RawImage(Fmt(int(img.fmt)), port.ColorGamut(int(img.cg)),
                         CT(int(img.ct)), port.ColorRange(int(img.range)),
                         img.w, img.h, [np.asarray(p) for p in img.planes])


def _sdr(jimg):
    return jax_jpegr.JpegR().tone_map(jimg)


# name -> (scale, multichannel, effects, with an SDR intent (API-1))
ENCODER_CASES = {
    "rotate90": (4, False, [("rotate", 90)], False),
    "crop_mirror": (1, True, [("crop", 8, 72, 4, 60), ("mirror", 1)], False),
    "crop_not_divisible_by_scale": (4, False, [("crop", 0, 90, 0, 62)],
                                    False),
    "resize": (1, True, [("resize", 48, 30)], False),
    "upscale_quirk": (4, False, [("resize", 130, 70)], False),
    "crop_odd": (4, False, [("crop", 3, 80, 1, 60)], False),
    "invalid_crop": (1, True, [("crop", 10, 5, 0, 10)], False),
    "invalid_resize": (1, True, [("resize", 0, 8)], False),
    "api1_rotate270_crop": (1, True, [("rotate", 270), ("crop", 0, 40, 16,
                                                        80)], True),
}


def _encode(mod, img, sdr, scale, mc, spec, **kw):
    enc = mod.UhdrEncoder(**kw)
    enc.set_raw_image(img, mod.ImgLabel.HDR)
    if sdr is not None:
        enc.set_raw_image(sdr, mod.ImgLabel.SDR)
    enc.set_gainmap_scale_factor(scale)
    enc.set_using_multi_channel_gainmap(mc)
    add_effects(enc, spec)
    try:
        return enc.encode()
    except Exception as e:
        return e


def _coeffs(data):
    out = []
    for jpeg in testing.read_jpegr(data)[:2]:
        coeffs, _, _ = port_fused.decode_coefficients(jpeg, parse_jpeg(jpeg))
        out.append(coeffs)
    return out


def _jax_hlg(data):
    img, _, _ = jax_jpegr.JpegR().decode(data, jax_types.ColorTransfer.HLG,
                                         jax_types.ImgFmt.RGBA1010102)
    return np.asarray(img.planes[0])


@pytest.mark.parametrize("case", list(ENCODER_CASES))
def test_encoder_effects(case):
    scale, mc, spec, api1 = ENCODER_CASES[case]
    jimg = benchmarks.photo_p010(W, H)
    jsdr = _sdr(jimg) if api1 else None
    img = _to_port(jimg)
    sdr = _to_port(jsdr) if api1 else None
    got = _encode(port, img, sdr, scale, mc, spec, device="cpu")
    want = _encode(jax_api, jimg, jsdr, scale, mc, spec)
    if isinstance(want, Exception):
        assert isinstance(got, Exception), case
        assert error_code(got) == jax_bridge.error_tuple(want)[0]
        return
    assert isinstance(got, bytes), got
    # the port's encode of the intents edited beforehand
    edited = _editor(img, spec), _editor(sdr, spec) if api1 else None
    assert got == _encode(port, *edited, scale, mc, [], device="cpu")
    # against the JAX file: the geometry, the coefficients, the decode
    jr = port.JpegR(device="cpu")
    pg, jg = jr.get_info(got), jr.get_info(want)
    for key in ("primary", "gainmap"):
        assert (pg[key].width, pg[key].height) == \
            (jg[key].width, jg[key].height)
    for cp, cj in zip(_coeffs(got), _coeffs(want)):
        for a, b in zip(cp, cj):
            diff = np.abs(a.astype(np.int32) - b)
            assert diff.max() <= 1 and (diff > 0).mean() <= 64e-3, case
    assert testing.psnr(_jax_hlg(got), _jax_hlg(want)) >= 60.0, case


def test_effects_with_compressed_intents_are_refused():
    """JAX tests/test_api.py: effects with API-2/3/4 raise
    invalid_operation before any encode."""
    base_file = _jax_file(2, False)
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(base_file)
    dec.probe()
    img = _to_port(benchmarks.photo_p010(W, H))
    sdr = _to_port(_sdr(benchmarks.photo_p010(W, H)))
    cases = {
        "api4": lambda e: (e.set_compressed_image(port.CompressedImage(
            dec.get_base_image(), port.ColorGamut.DISPLAY_P3),
            port.ImgLabel.BASE), e.set_gainmap_image(port.CompressedImage(
                dec.get_gainmap_image()), dec.get_gainmap_metadata())),
        "api3": lambda e: (e.set_raw_image(img, port.ImgLabel.HDR),
                           e.set_compressed_image(port.CompressedImage(
                               dec.get_base_image(),
                               port.ColorGamut.DISPLAY_P3),
                               port.ImgLabel.SDR)),
        "api2": lambda e: (e.set_raw_image(img, port.ImgLabel.HDR),
                           e.set_raw_image(sdr, port.ImgLabel.SDR),
                           e.set_compressed_image(port.CompressedImage(
                               dec.get_base_image(),
                               port.ColorGamut.DISPLAY_P3),
                               port.ImgLabel.SDR)),
    }
    for name, setup in cases.items():
        enc = port.UhdrEncoder(device="cpu")
        setup(enc)
        enc.add_effect_rotate(90)
        with pytest.raises(port.UhdrError) as e:
            enc.encode()
        assert e.value.code == \
            port.UhdrErrorCode.UHDR_CODEC_INVALID_OPERATION, name


# ---------------------------------------------------------------------------
# enable_gpu_acceleration(False): the general path


def test_disabled_acceleration_takes_the_general_path():
    img = testing.photo_p010(W, H)
    sdr = port.JpegR(device="cpu").tone_map(img)
    jr = port.JpegR(device="cpu", map_dimension_scale_factor=2)
    for with_sdr in (False, True):
        enc = port.UhdrEncoder(device="cpu")
        enc.set_raw_image(img, port.ImgLabel.HDR)
        if with_sdr:
            enc.set_raw_image(sdr, port.ImgLabel.SDR)
        enc.set_gainmap_scale_factor(2)
        enc.enable_gpu_acceleration(False)
        got = enc.encode()
        want = jr.encode_api1(img, sdr, 95, use_fused=False) if with_sdr \
            else jr.encode_api0(img, 95, use_fused=False)
        fused = jr.encode_api1(img, sdr, 95) if with_sdr \
            else jr.encode_api0(img, 95)
        assert got == want
        assert got != fused
    data = _jax_file(4, False)
    for out in ("HLG", "LINEAR"):
        dec = _port_decoder(data, out, gpu=False)
        want, _, want_gm = port.JpegR(device="cpu").decode(
            data, OUTPUTS[out][0], return_gainmap=True, use_fused=False)
        np.testing.assert_array_equal(dec.decode().planes[0],
                                      want.planes[0])
        np.testing.assert_array_equal(dec.get_decoded_gainmap_image()
                                      .planes[0], want_gm.planes[0])
