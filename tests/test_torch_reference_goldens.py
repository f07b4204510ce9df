"""PyTorch port: held against the reference library's own goldens.

``tests/goldens/*.npz`` were written once by the reference library
(``tools/make_reference_goldens.py``): each holds a raw input, the
reference's JPEG_R of it and the reference's HLG, PQ, LINEAR and SRGB
decodes of those bytes; the effects golden its rasters of 9 effect queues.
Every case of ``tests/test_reference_goldens.py`` runs here on the port,
on the CPU (``device="cpu"``), at that file's gates (``testing``'s
``DECODE_GATE_DB`` and the rest):

- decode: the port's decode of the reference's bytes against the
  reference's decode, >= 60 dB on HLG and PQ (RGBA1010102, peak 1023),
  LINEAR (RGBAF16, peak 10000/203) and SRGB (RGBA8888, peak 255);
- encode: the port's encode of the golden's input at its configuration,
  decoded by the port, against the reference's decode of its own encode,
  >= 48 dB, and no more than 12 dB below the anchor (the reference's bytes
  through the port's decoder), the anchor capped at 60 dB;
- both metadata kinds (ISO and XMP) among the goldens;
- effects through ``UhdrDecoder(device="cpu")``: SRGB exact for the
  permutations and the crop, >= 50 dB for the resizes; HLG >= 60 dB, the
  resizes >= 50 dB.

And two checks that the JAX file lacks:

- the port's decode of each reference file against the JAX package's
  decode of the same bytes: SRGB bit for bit, HLG, PQ and LINEAR within
  ``testing.check_decoded_close`` (the decode-output contract between two
  programs: 10-bit codes neighbours among the attainable codes, half
  floats within 4 ulps, at most 5e-3 / 1e-3 of the samples off, >= 60
  dB); LINEAR against the JAX package's general path, because its fused
  program is one gain-grid step off the reference's raster at a few
  samples where the port is not (fault F5 of the JAX package,
  ``test_jax_fused_linear_decode_off_the_reference``);
- the port's encode of each golden input (through ``UhdrEncoder`` at the
  golden's configuration, byte for byte the ``JpegR`` encode), decoded by
  the JAX decoder, >= 48 dB against the reference's raster.
"""

import numpy as np
import pytest

from libultrahdr_tpu.jpegr import JpegR as JaxJpegR

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import testing

from test_torch_jax_native import guard_jax_native

guard_jax_native()

CT, Fmt = port.ColorTransfer, port.ImgFmt
NAMES = testing.golden_names()
EFFECTS = testing.golden_effects()
# output transfer -> (its format, the golden's raster, the PSNR)
OUTPUTS = {CT.HLG: (Fmt.RGBA1010102, "dec_hlg_1010102", testing.psnr),
           CT.PQ: (Fmt.RGBA1010102, "dec_pq_1010102", testing.psnr),
           CT.LINEAR: (Fmt.RGBAF16, "dec_linear_f16", testing.psnr),
           CT.SRGB: (Fmt.RGBA8888, "dec_srgb_8888", testing.psnr_8888)}


def _decode(data: bytes, ct) -> np.ndarray:
    fmt = OUTPUTS[ct][0]
    return np.asarray(port.JpegR(device="cpu").decode(
        data, output_ct=ct, output_fmt=fmt)[0].planes[0])


def _decode_parity(name, ct):
    z, _ = testing.load_golden(name)
    data = bytes(z["jpegr"])
    assert port.is_uhdr_image(data)
    _, key, psnr = OUTPUTS[ct]
    db = psnr(_decode(data, ct), z[key])
    assert db >= testing.DECODE_GATE_DB, \
        f"{name}: {ct.name} cross-decoder PSNR {db:.2f} dB"


@pytest.mark.parametrize("name", NAMES)
def test_decode_parity_hlg(name):
    _decode_parity(name, CT.HLG)


@pytest.mark.parametrize("name", NAMES)
def test_decode_parity_pq(name):
    _decode_parity(name, CT.PQ)


@pytest.mark.parametrize("name", NAMES)
def test_decode_parity_linear(name):
    _decode_parity(name, CT.LINEAR)


@pytest.mark.parametrize("name", NAMES)
def test_decode_parity_srgb(name):
    _decode_parity(name, CT.SRGB)


def _port_encode(z, cfg) -> bytes:
    return port.JpegR(device="cpu", **testing.golden_jpegr_knobs(cfg)
                      ).encode_api0(testing.golden_input(z, cfg),
                                    quality=cfg["quality"])


@pytest.mark.parametrize("name", NAMES)
def test_encode_parity(name):
    """The golden's input encoded by the port at the reference's
    configuration and decoded by the port, against the reference's decode
    of its own encode (both encoders lossy)."""
    z, cfg = testing.load_golden(name)
    data = _port_encode(z, cfg)
    assert port.is_uhdr_image(data)
    cross = testing.psnr(_decode(data, CT.HLG), z["dec_hlg_1010102"])
    anchor = testing.psnr(_decode(bytes(z["jpegr"]), CT.HLG),
                                  z["dec_hlg_1010102"])
    assert cross >= testing.ENCODE_GATE_DB, \
        f"{name}: cross-encoder PSNR {cross:.2f} dB"
    assert cross >= min(anchor, testing.ANCHOR_CAP_DB) \
        - testing.ENCODE_SLACK_DB, (
        f"{name}: the port's encode loses {anchor - cross:.2f} dB against "
        "the reference's encode through the same decoder")


def test_xmp_and_iso_goldens_both_present():
    assert {testing.load_golden(n)[1]["metadata"] for n in NAMES} == \
        {"iso", "xmp"}


def _decode_with_effects(data, queue, ct, fmt):
    dec = port.UhdrDecoder(device="cpu")
    dec.set_image(data)
    dec.set_out_color_transfer(ct)
    dec.set_out_img_format(fmt)
    testing.queue_effects(dec, queue)
    return np.asarray(dec.decode().planes[0])


def test_effects_golden_holds_the_reference_tests_queues():
    """The queues read from the effects golden are the nine of the JAX
    file, on the same bytes as ``p010_iso_single_s4``."""
    assert [n for n, _ in EFFECTS] == [
        "rot90", "rot180", "rot270", "mirror_v", "mirror_h", "crop",
        "resize_half", "resize_odd", "rot90_mirror_h"]
    assert dict(EFFECTS)["crop"] == [("crop", (16, 240, 8, 152))]
    z, _ = testing.load_golden(testing.EFFECTS_GOLDEN)
    twin, _ = testing.load_golden("p010_iso_single_s4")
    assert np.array_equal(z["jpegr"], twin["jpegr"])


@pytest.mark.parametrize("name,queue", EFFECTS, ids=[n for n, _ in EFFECTS])
def test_effect_parity_srgb(name, queue):
    """SRGB: the decode is libjpeg's bit for bit and rotate, mirror and
    crop are index permutations, so equal to the reference's pixels;
    resize (float bicubic) >= 50 dB."""
    z, _ = testing.load_golden(testing.EFFECTS_GOLDEN)
    ours = _decode_with_effects(bytes(z["jpegr"]), queue, CT.SRGB,
                                Fmt.RGBA8888)
    ref = z[f"{name}_srgb"]
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    if "resize" in name:
        assert testing.psnr_8888(ours, ref) >= testing.RESIZE_GATE_DB
    else:
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("name,queue", EFFECTS, ids=[n for n, _ in EFFECTS])
def test_effect_parity_hlg(name, queue):
    """HLG: two decoders (>= 60 dB) and the effect; resize >= 50 dB."""
    z, _ = testing.load_golden(testing.EFFECTS_GOLDEN)
    ours = _decode_with_effects(bytes(z["jpegr"]), queue, CT.HLG,
                                Fmt.RGBA1010102)
    ref = z[f"{name}_hlg"]
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    gate = testing.RESIZE_GATE_DB if "resize" in name \
        else testing.DECODE_GATE_DB
    assert testing.psnr(ours, ref) >= gate


# ---- beyond the JAX file ---------------------------------------------------

@pytest.mark.parametrize("ct", list(OUTPUTS), ids=[c.name for c in OUTPUTS])
@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_jax(name, ct):
    """The port's decode of the reference's bytes against the JAX
    package's: SRGB bit for bit, the HDR outputs within the decode-output
    contract (LINEAR against the JAX package's general path, F5)."""
    z, _ = testing.load_golden(name)
    data = bytes(z["jpegr"])
    fmt = OUTPUTS[ct][0]
    # LINEAR: the JAX package's general path, as its fused program's
    # LINEAR samples are off the reference's (F5,
    # test_jax_fused_linear_decode_off_the_reference)
    want = np.asarray(JaxJpegR().decode(
        data, output_ct=ct, output_fmt=fmt,
        use_fused=ct != CT.LINEAR)[0].planes[0])
    got = _decode(data, ct)
    if ct == CT.SRGB:
        np.testing.assert_array_equal(got, want)
    else:
        testing.check_decoded_close(got, want, ct, f"{name} {ct.name}")


def _ulps(a, b) -> np.ndarray:
    return np.abs(a.view(np.uint16).astype(np.int64)
                  - b.view(np.uint16).astype(np.int64))


def test_jax_fused_linear_decode_off_the_reference():
    """F5, a fault of the JAX package that the port does not share: on the
    reference's P010 files the JAX package's fused decode program gives
    LINEAR samples 7-10 half-float ulps (one step of the gain grid) off the
    reference's raster at samples where its own general path is within
    F16_MAX_ULPS of it; there the port, on either route, is within
    F16_MAX_ULPS too, and elsewhere the port is no more often off the
    raster than that general path."""
    off_fused = 0
    for name in NAMES:
        z, _ = testing.load_golden(name)
        data, ref = bytes(z["jpegr"]), z["dec_linear_f16"]
        jax_fused, jax_general = (np.asarray(JaxJpegR().decode(
            data, output_ct=CT.LINEAR, use_fused=f)[0].planes[0])
            for f in (True, False))
        far = (_ulps(jax_fused, ref) > testing.F16_MAX_ULPS) \
            & (_ulps(jax_general, ref) <= testing.F16_MAX_ULPS)
        off_fused += int(far.sum())
        for fused in (True, False):
            got = np.asarray(port.JpegR(device="cpu").decode(
                data, output_ct=CT.LINEAR, use_fused=fused)[0].planes[0])
            assert (_ulps(got, ref)[far] <= testing.F16_MAX_ULPS).all(), name
            assert (_ulps(got, ref) > testing.F16_MAX_ULPS).sum() <= \
                (_ulps(jax_general, ref) > testing.F16_MAX_ULPS).sum(), name
    assert off_fused > 0


@pytest.mark.parametrize("name", NAMES)
def test_port_encode_decoded_by_jax(name):
    """The port's encode of the golden's input through ``UhdrEncoder`` at
    the golden's configuration (ISO or XMP as the golden has it) equals its
    ``JpegR`` encode, and the JAX decoder's HLG decode of it reaches the
    cross-encoder gate against the reference's raster."""
    z, cfg = testing.load_golden(name)
    with testing.golden_metadata(cfg):
        data = testing.golden_encoder(z, cfg, "cpu").encode()
    assert data == _port_encode(z, cfg)
    gm = port.JpegR.extract_primary_and_gainmap(data)[1]
    info = port.jpeg.parse_jpeg(gm)
    assert (info.iso is not None, info.xmp is not None) == (
        cfg["metadata"] == "iso", cfg["metadata"] == "xmp")
    jax_dec = np.asarray(JaxJpegR().decode(
        data, output_ct=CT.HLG)[0].planes[0])
    db = testing.psnr(jax_dec, z["dec_hlg_1010102"])
    assert db >= testing.ENCODE_GATE_DB, \
        f"{name}: the port's encode through the JAX decoder {db:.2f} dB"
