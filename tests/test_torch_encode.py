"""PyTorch port: the API-0 P010 encode end to end against the JAX package.

Both configurations of the main path, on photographic content at 130x66 (an
odd size that needs MCU padding): the library default (map scale 1,
3-channel gain map, 4:4:4 map scan) and the reference benchmark's (scale 4,
single channel, 4:0:0).  The port encodes through UhdrEncoder(device="cpu")
with the knobs of the JAX JpegR it is compared with.

- The JAX decoder reads the port's file, and its HLG RGBA1010102 output is
  within 60 dB PSNR of its decode of the JAX encode of the same input (the
  float stages may differ by an ulp, test_torch_ops.py).
- Fed the JAX package's own quantised coefficients, the port's entropy
  stage and container writer give the JAX file byte for byte.
"""

import functools

import numpy as np
import pytest
import torch

import benchmarks
from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu.jpeg import decoder as jax_decoder
from libultrahdr_tpu.types import ColorTransfer, ImgFmt

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg import decoder as port_decoder
from libultrahdr_tpu_torch.jpeg import device_entropy as port_de
from libultrahdr_tpu_torch.jpeg import pack_kernel as port_pk

from test_torch_jax_native import guard_jax_native

guard_jax_native()

W, H = 130, 66
CONFIGS = {
    "default": {},
    "benchmark": {"map_dimension_scale_factor": 4,
                  "use_multi_channel_gainmap": False},
}


def _knobs(jr):
    d = {k: getattr(jr, k) for k in port.jpegr.KNOBS}
    d["preset"] = int(d["preset"])
    return d


@functools.lru_cache(maxsize=None)
def _encodes(cfg):
    """(image, JAX JpegR, JAX file, port file) for a configuration."""
    img = benchmarks.photo_p010(W, H)
    jr = jax_jpegr.JpegR(**CONFIGS[cfg])
    jax_file = jr.encode_api0(img, 95)
    enc = port.UhdrEncoder(device="cpu")
    enc.set_raw_image(testing.photo_p010(W, H), port.ImgLabel.HDR)
    enc.set_quality(95, port.ImgLabel.BASE)
    enc.set_gainmap_scale_factor(jr.map_dimension_scale_factor)
    enc.set_using_multi_channel_gainmap(jr.use_multi_channel_gainmap)
    return img, jr, jax_file, enc.encode()


@functools.lru_cache(maxsize=None)
def _jax_decode(data):
    out, _, _ = jax_jpegr.JpegR().decode(data, ColorTransfer.HLG,
                                         ImgFmt.RGBA1010102)
    packed = np.asarray(out.planes[0]).astype(np.int64)
    return np.stack([(packed >> s) & 1023 for s in (0, 10, 20)])


@pytest.mark.parametrize("cfg", CONFIGS)
def test_port_file_decodes_in_jax_at_60db(cfg):
    _, _, jax_file, port_file = _encodes(cfg)
    ref = _jax_decode(jax_file)
    got = _jax_decode(port_file)
    assert got.shape == ref.shape == (3, H, W)
    mse = np.mean((got - ref).astype(np.float64) ** 2)
    psnr = np.inf if mse == 0 else 10 * np.log10(1023.0 ** 2 / mse)
    assert psnr >= 60.0, psnr


@pytest.mark.parametrize("cfg", CONFIGS)
def test_entropy_stage_on_jax_coefficients_gives_jax_file(cfg):
    """Decode the JAX file's scans to its coefficients, run them through
    the port's stream glue, plain pack, joiner and container writer: the
    result is the JAX file, byte for byte."""
    img, jr, jax_file, _ = _encodes(cfg)
    primary, gm_jpeg, _ = testing.read_jpegr(jax_file)
    pjr = port.JpegR.from_reference_knobs(_knobs(jr), device="cpu")
    scale = port_fused._resolve_scale(pjr, img)
    gm_sampling = port_fused._SAMPLING_444 if pjr.use_multi_channel_gainmap \
        else port_fused._SAMPLING_400
    layouts = [port_fused._layout_for(H, W, port_fused._SAMPLING_420),
               port_fused._layout_for(H // scale, W // scale, gm_sampling)]
    scans = []
    for jpeg, layout in zip((primary, gm_jpeg), layouts):
        coeffs = testing.decode_scan_coeffs(jpeg, layout)
        ins = port_de.stream_inputs([torch.from_numpy(c) for c in coeffs],
                                    layout)
        words, blen = port_pk.pack_scan(*ins)
        scan = port_fused.fetch_blocks_multi(
            words.numpy().view(np.uint32),
            [(blen.numpy().astype(np.uint16), layout.bpr)])[0]
        assert scan == testing.scan_data(jpeg)
        scans.append(scan)
    md = port_fused._onepass_metadata(pjr, port.ColorTransfer.HLG, False)
    out = port_fused._assemble_container(
        pjr, W, H, 95, scans[0], port_fused._SAMPLING_420,
        port.ColorGamut.DISPLAY_P3, scale, scans[1], md, None,
        port.ColorTransfer.HLG, port.ColorGamut.BT2100)
    assert out == jax_file


@pytest.mark.parametrize("cfg", CONFIGS)
def test_port_encode_checks(cfg):
    """The port's file: two JPEGs and ISO metadata in the MPF container,
    scans that decode to exactly the coefficients the port computed, and
    the same bytes through JpegR.from_reference_knobs as through
    UhdrEncoder."""
    img, jr, _, port_file = _encodes(cfg)
    primary, gm_jpeg, md = testing.read_jpegr(port_file)
    np.testing.assert_allclose(md.max_content_boost, 1000.0 / 203.0,
                               rtol=1e-6)
    pjr = port.JpegR.from_reference_knobs(_knobs(jr), device="cpu")
    assert pjr.encode_api0(img, 95) == port_file
    y, uv = port_fused.upload_p010(img, torch.device("cpu"))
    scans = port_fused._api0_p010_block_buffers(
        y, uv, cg=port.ColorGamut.BT2100, ct=port.ColorTransfer.HLG,
        rng=port.ColorRange.FULL, scale=pjr.map_dimension_scale_factor,
        multichannel=pjr.use_multi_channel_gainmap, gamma=1.0, quality=95,
        map_quality=95, use_base_cg=False)
    for jpeg, (src, layout) in zip((primary, gm_jpeg), scans):
        for got, want in zip(testing.decode_scan_coeffs(jpeg, layout),
                             testing.scan_coeffs(src, layout)):
            np.testing.assert_array_equal(got, want.numpy())


def test_scale_resolution_matches_jax():
    """An unusable map scale is replaced and written back into the knob,
    as the JAX package's _dispatch_api0_p010 does."""
    img = testing.photo_p010(W, H)
    for factor in (1, 4, 67, 128):
        ref = jax_jpegr.JpegR(map_dimension_scale_factor=factor)
        pjr = port.JpegR(device="cpu", map_dimension_scale_factor=factor)
        assert port_fused._resolve_scale(pjr, img) == \
            jax_fused._resolve_scale(ref, img)
        assert pjr.map_dimension_scale_factor == \
            ref.map_dimension_scale_factor


def test_encoder_lifecycle_and_validation():
    img = testing.photo_p010(64, 48)
    enc = port.UhdrEncoder(device="cpu")
    with pytest.raises(port.UhdrError) as e:
        enc.encode()                 # no HDR image: error, and it sticks
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_OPERATION
    with pytest.raises(port.UhdrError):
        enc.encode()
    assert enc.get_encoded_stream() is None
    with pytest.raises(port.UhdrError):
        enc.set_quality(90, port.ImgLabel.BASE)          # sailed
    enc.reset()
    for bad in (lambda: enc.set_quality(101, port.ImgLabel.BASE),
                lambda: enc.set_quality(90, port.ImgLabel.HDR),
                lambda: enc.set_gainmap_scale_factor(0),
                lambda: enc.set_gainmap_scale_factor(129),
                lambda: enc.set_gainmap_gamma(0.0),
                lambda: enc.set_gainmap_gamma(float("inf")),
                lambda: enc.set_raw_image(None, port.ImgLabel.HDR)):
        with pytest.raises(port.UhdrError) as e:
            bad()
        assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM
    odd = testing.photo_p010(64, 48)
    odd.w = 63
    with pytest.raises(port.UhdrError):
        enc.set_raw_image(odd, port.ImgLabel.HDR)
    srgb = testing.photo_p010(64, 48)
    srgb.ct = port.ColorTransfer.SRGB
    with pytest.raises(port.UhdrError):
        enc.set_raw_image(srgb, port.ImgLabel.HDR)
    with pytest.raises(port.UhdrError) as e:
        enc.set_raw_image(img, port.ImgLabel.SDR)   # P010 is no SDR format
    assert e.value.code == port.UhdrErrorCode.UHDR_CODEC_INVALID_PARAM
    enc.set_raw_image(img, port.ImgLabel.HDR)
    data = enc.encode()
    assert enc.encode() is data and enc.get_encoded_stream() is data
    testing.read_jpegr(data)


def test_other_hdr_formats_raise_unsupported():
    """Every API-0 HDR format is ported, and an SDR intent beside the HDR
    one selects API-1.  A compressed SDR intent marked progressive (API-3)
    no longer raises unsupported: the general decode path reads it, as the
    JAX package's does, and the SDR planes it reads are the JAX
    package's."""
    rgba = testing.photo_rgba1010102(16, 16)
    enc = port.UhdrEncoder(device="cpu")
    enc.set_raw_image(rgba, port.ImgLabel.HDR)
    sdr = port.RawImage(port.ImgFmt.RGBA8888, port.ColorGamut.DISPLAY_P3,
                        port.ColorTransfer.SRGB, port.ColorRange.FULL, 16, 16,
                        [np.zeros((16, 16), np.uint32)])
    enc.set_raw_image(sdr, port.ImgLabel.SDR)
    testing.read_jpegr(enc.encode())
    base, _, _ = testing.read_jpegr(enc.encode())
    sof = base.index(b"\xff\xc0")
    marked = base[:sof] + b"\xff\xc2" + base[sof + 2:]
    enc = port.UhdrEncoder(device="cpu")
    enc.set_raw_image(rgba, port.ImgLabel.HDR)
    enc.set_compressed_image(port.CompressedImage(marked), port.ImgLabel.SDR)
    primary, _, _ = testing.read_jpegr(enc.encode())
    assert jax_decoder.parse_jpeg(primary).progressive
    want, wfmt = jax_decoder.decode_to_planes(marked)
    got, gfmt = port_decoder.decode_to_planes(marked, None,
                                              device=torch.device("cpu"))
    assert int(gfmt) == int(wfmt)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
