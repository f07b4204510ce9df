"""PyTorch port: the API-0 encode of RGBA1010102, RGBAF16 and YUV444_10 HDR
input against the JAX package.

Inputs are photographic content at 131x67 (odd, so both the 4:4:4 base and
the gain map need MCU padding), from ``testing.photo_rgba1010102``,
``photo_rgbaf16`` and ``photo_yuv444_10``: RGBA1010102 as HLG/BT2100 and
PQ/Display-P3, RGBAF16 as LINEAR/BT2100, YUV444_10 as HLG/BT2100, each in
both configurations of the main path (the library default: map scale 1,
3-channel gain map; the reference benchmark's: scale 4, single channel).
The port encodes on the CPU with the knobs of the JAX JpegR it is compared
with, through UhdrEncoder where the reference API takes the format (not
YUV444_10) and JpegR.from_reference_knobs otherwise.

- The JAX decoder reads the port's file, and its HLG RGBA1010102 output is
  within 60 dB PSNR of its decode of the JAX encode of the same input.
- Fed the JAX package's own quantised coefficients, the port's entropy
  stage and container writer give the JAX file byte for byte.
- The SDR base planes and the gain map agree as u8 planes within 1 on at
  most 1e-3 of the samples (at least one): the tone map and the gain map
  are float pipelines whose log2/pow/exp differ between the frameworks by an
  ulp now and then, which can flip a truncation to u8
  (tests/test_torch_ops.py).  Each stage is held on the same inputs.

The unpackers are exact, half-float NaN and infinities included.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu import jpegr as jax_jpegr
from libultrahdr_tpu import types as jax_types
from libultrahdr_tpu.ops import colors as jax_colors
from libultrahdr_tpu.ops import gainmap as jax_gainmap
from libultrahdr_tpu.ops import pixel as jax_pixel
from libultrahdr_tpu.ops import tonemap as jax_tonemap

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg import pack_kernel as port_pk
from libultrahdr_tpu_torch.ops import colors as port_colors
from libultrahdr_tpu_torch.ops import gainmap as port_gainmap
from libultrahdr_tpu_torch.ops import pixel as port_pixel
from libultrahdr_tpu_torch.ops import tonemap as port_tonemap

W, H = 131, 67
CPU = torch.device("cpu")
Fmt, CG, CT = port.ImgFmt, port.ColorGamut, port.ColorTransfer
# name -> (content, transfer, gamut)
FORMATS = {
    "1010102_hlg_bt2100": (testing.photo_rgba1010102, CT.HLG, CG.BT2100),
    "1010102_pq_p3": (testing.photo_rgba1010102, CT.PQ, CG.DISPLAY_P3),
    "f16_linear_bt2100": (testing.photo_rgbaf16, CT.LINEAR, CG.BT2100),
    "yuv444_10_hlg_bt2100": (testing.photo_yuv444_10, CT.HLG, CG.BT2100),
}
CONFIGS = {
    "default": {},
    "benchmark": {"map_dimension_scale_factor": 4,
                  "use_multi_channel_gainmap": False},
}
CASES = [(f, c) for f in FORMATS for c in CONFIGS]


def _image(fmt_name):
    make, ct, cg = FORMATS[fmt_name]
    img = make(W, H)
    img.ct, img.cg = ct, cg
    return img


def _jax_image(img):
    return jax_types.RawImage(int(img.fmt), int(img.cg), int(img.ct),
                              int(img.range), img.w, img.h, list(img.planes))


def _knobs(jr):
    d = {k: getattr(jr, k) for k in port.jpegr.KNOBS}
    d["preset"] = int(d["preset"])
    return d


@functools.lru_cache(maxsize=None)
def _encodes(fmt_name, cfg):
    """(image, JAX JpegR, JAX file, port file)."""
    img = _image(fmt_name)
    jr = jax_jpegr.JpegR(**CONFIGS[cfg])
    jax_file = jr.encode_api0(_jax_image(img), 95)
    if img.fmt == Fmt.YUV444_10:
        port_file = port.JpegR.from_reference_knobs(
            _knobs(jr), device="cpu").encode_api0(img, 95)
    else:
        enc = port.UhdrEncoder(device="cpu")
        enc.set_raw_image(img, port.ImgLabel.HDR)
        enc.set_quality(95, port.ImgLabel.BASE)
        enc.set_gainmap_scale_factor(jr.map_dimension_scale_factor)
        enc.set_using_multi_channel_gainmap(jr.use_multi_channel_gainmap)
        port_file = enc.encode()
    return img, jr, jax_file, port_file


@functools.lru_cache(maxsize=None)
def _jax_decode(data):
    out, _, _ = jax_jpegr.JpegR().decode(data, jax_types.ColorTransfer.HLG,
                                         jax_types.ImgFmt.RGBA1010102)
    packed = np.asarray(out.planes[0]).astype(np.int64)
    return np.stack([(packed >> s) & 1023 for s in (0, 10, 20)])


def _layouts(img, pjr):
    scale = port_fused._resolve_scale(pjr, img)
    gm_sampling = port_fused._SAMPLING_444 if pjr.use_multi_channel_gainmap \
        else port_fused._SAMPLING_400
    return scale, [port_fused._layout_for(H, W, port_fused._SAMPLING_444),
                   port_fused._layout_for(H // scale, W // scale,
                                          gm_sampling)]


@pytest.mark.parametrize("fmt_name,cfg", CASES)
def test_port_file_decodes_in_jax_at_60db(fmt_name, cfg):
    _, _, jax_file, port_file = _encodes(fmt_name, cfg)
    ref = _jax_decode(jax_file)
    got = _jax_decode(port_file)
    assert got.shape == ref.shape == (3, H, W)
    mse = np.mean((got - ref).astype(np.float64) ** 2)
    psnr = np.inf if mse == 0 else 10 * np.log10(1023.0 ** 2 / mse)
    assert psnr >= 60.0, psnr


@pytest.mark.parametrize("fmt_name,cfg", CASES)
def test_entropy_stage_on_jax_coefficients_gives_jax_file(fmt_name, cfg):
    """The JAX file's scans decoded to coefficients, then the port's stream
    glue, plain pack (both scans in one call, as the encode packs them),
    joiner and container writer: the JAX file, byte for byte."""
    img, jr, jax_file, _ = _encodes(fmt_name, cfg)
    primary, gm_jpeg, _ = testing.read_jpegr(jax_file)
    pjr = port.JpegR.from_reference_knobs(_knobs(jr), device="cpu")
    scale, layouts = _layouts(img, pjr)
    scans = [([torch.from_numpy(c) for c in
               testing.decode_scan_coeffs(jpeg, layout)], layout)
             for jpeg, layout in zip((primary, gm_jpeg), layouts)]
    words, blen = port_fused._pack_scans(scans, port_pk.pack_scan)
    blen = blen.numpy().astype(np.uint16)
    n_base = layouts[0].mcus_h * layouts[0].bpr
    base_scan, gm_scan = port_fused.fetch_blocks_multi(
        words.numpy().view(np.uint32),
        [(blen[:n_base], layouts[0].bpr), (blen[n_base:], layouts[1].bpr)])
    assert base_scan == testing.scan_data(primary)
    assert gm_scan == testing.scan_data(gm_jpeg)
    use_base_cg = port_fused._use_base_cg(CG.DISPLAY_P3, CG(img.cg),
                                          pjr.write_xmp)
    md = port_fused._onepass_metadata(pjr, CT(img.ct), use_base_cg)
    out = port_fused._assemble_container(
        pjr, W, H, 95, base_scan, port_fused._SAMPLING_444, CG.DISPLAY_P3,
        scale, gm_scan, md, None, CT(img.ct), CG(img.cg))
    assert out == jax_file


def _stages(fmt_name, cfg, side, gain_inputs=None):
    """((Y, Cb, Cr, gain map) u8 planes, (SDR, HDR) float values) of the
    encode's device stages, by the JAX package (side "jax") or the port on
    the CPU (side "port").  With `gain_inputs` (the other side's SDR and HDR
    values) the gain map is made from those, so that the tone map and the
    gain map are each held to their own contract: one u8 step of a dark SDR
    sample moves its full-resolution gain by several steps."""
    img = _image(fmt_name)
    jax_side = side == "jax"
    enums = jax_types if jax_side else port
    fmt, cg, ct = (enums.ImgFmt(int(img.fmt)), enums.ColorGamut(int(img.cg)),
                   enums.ColorTransfer(int(img.ct)))
    p3 = enums.ColorGamut.DISPLAY_P3
    knobs = CONFIGS[cfg]
    scale = knobs.get("map_dimension_scale_factor", 1)
    multichannel = knobs.get("use_multi_channel_gainmap", True)
    pixel = jax_pixel if jax_side else port_pixel
    tonemap = jax_tonemap if jax_side else port_tonemap
    fused = jax_fused if jax_side else port_fused
    planes = [jnp.asarray(p) for p in img.planes] if jax_side \
        else port_fused.upload_planes(img.planes, CPU)
    if fmt == Fmt.YUV444_10:
        hdr = pixel.unpack_yuv444_10(*planes, enums.ColorRange(img.range))
        y8, u8, v8 = tonemap.tonemap_to_yuv(hdr, fmt, cg, ct,
                                            out_yuv420=False)
        sdr = pixel.unpack_yuv8(y8, u8, v8, 1, 1, H, W)
        sdr_fmt = enums.ImgFmt.YUV444
    else:
        unpack = pixel.unpack_rgba1010102 if fmt == Fmt.RGBA1010102 \
            else pixel.unpack_rgbaf16
        hdr = unpack(planes[0])
        sdr = pixel.unpack_rgba8888(tonemap.tonemap_to_rgba8888(hdr, fmt, cg,
                                                                ct))
        y8, u8, v8 = fused._rgb_vals_to_yuv444_planes(sdr, p3)
        sdr_fmt = enums.ImgFmt.RGBA8888
    vals = (np.asarray(sdr), np.asarray(hdr))
    if gain_inputs is not None:
        sdr, hdr = (jnp.asarray(a) if jax_side
                    else torch.from_numpy(np.array(a)) for a in gain_inputs)
    gm = (jax_gainmap if jax_side else port_gainmap).generate_gainmap_onepass(
        sdr, hdr, sdr_fmt=sdr_fmt, hdr_fmt=fmt, sdr_cg=p3, hdr_cg=cg, ct=ct,
        scale=scale, multichannel=multichannel, gamma=1.0,
        use_luminance=False, sdr_is_601=False,
        use_base_cg=port_fused._use_base_cg(CG.DISPLAY_P3, CG(int(cg)),
                                            False),
        max_boost=port_colors.reference_display_peak_nits(ct)
        / port_colors.SDR_WHITE_NITS)
    return [np.asarray(p).astype(np.int32) for p in (y8, u8, v8, gm)], vals


@pytest.mark.parametrize("fmt_name,cfg", CASES)
def test_sdr_and_gainmap_planes_match_jax(fmt_name, cfg):
    want, vals = _stages(fmt_name, cfg, "jax")
    got, _ = _stages(fmt_name, cfg, "port", gain_inputs=vals)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        diff = np.abs(a - b)
        assert diff.max() <= 1
        # 1e-3 of the samples, and never less than one: the benchmark
        # configuration's map has only 512
        assert (diff > 0).sum() <= max(1, 1e-3 * diff.size)


@pytest.mark.parametrize("fmt_name", FORMATS)
def test_port_encode_checks(fmt_name):
    """The port's file (default configuration): two JPEGs and ISO metadata
    in the MPF container, a 4:4:4 base whose scans decode to exactly the
    coefficients the port computed, and the same bytes through
    JpegR.from_reference_knobs as through UhdrEncoder."""
    img, jr, _, port_file = _encodes(fmt_name, "default")
    primary, gm_jpeg, md = testing.read_jpegr(port_file)
    peak = port_colors.reference_display_peak_nits(CT(img.ct))
    np.testing.assert_allclose(md.max_content_boost, peak / 203.0,
                               rtol=1e-6)
    pjr = port.JpegR.from_reference_knobs(_knobs(jr), device="cpu")
    assert pjr.encode_api0(img, 95) == port_file
    _, layouts = _layouts(img, pjr)
    kw = dict(cg=CG(img.cg), ct=CT(img.ct), scale=1, multichannel=True,
              gamma=1.0, quality=95, map_quality=95,
              use_base_cg=port_fused._use_base_cg(CG.DISPLAY_P3, CG(img.cg),
                                                  False))
    planes = port_fused.upload_planes(img.planes, CPU)
    if img.fmt == Fmt.YUV444_10:
        scans = port_fused._api0_yuv444_10_block_buffers(
            *planes, rng=port.ColorRange.FULL, **kw)
    else:
        scans = port_fused._api0_rgb_block_buffers(planes[0], fmt=img.fmt,
                                                   **kw)
    for jpeg, (src, layout), want_layout in zip((primary, gm_jpeg), scans,
                                                layouts):
        assert layout == want_layout
        for got, want in zip(testing.decode_scan_coeffs(jpeg, layout),
                             testing.scan_coeffs(src, layout)):
            np.testing.assert_array_equal(got, want.numpy())


# ---- the new unpackers and packers against the JAX package ---------------

def _nasty_f16(rs, shape):
    """Half-float patterns: ordinary values, both zeros, subnormals, +-inf,
    NaNs, negatives and values above the linear peak 10000/203."""
    vals = rs.uniform(-2.0, 60.0, shape).astype(np.float16).view(np.uint16)
    specials = np.array([0x0000, 0x8000, 0x0001, 0x03FF, 0x7C00, 0xFC00,
                         0x7E00, 0xFE01, 0x7BFF, 0x3C00], np.uint16)
    flat = vals.reshape(-1)
    flat[:specials.size] = specials
    return vals


def test_unpack_rgb_formats_exact():
    rs = np.random.RandomState(5)
    rgba = rs.randint(0, 2 ** 32, (17, 23), dtype=np.uint64).astype(
        np.uint32)
    f16 = _nasty_f16(rs, (17, 23, 4))
    yuv = [rs.randint(0, 1024, (17, 23)).astype(np.uint16) for _ in range(3)]
    (t_rgba,), (t_f16,) = (port_fused.upload_planes([a], CPU)
                           for a in (rgba, f16))
    t_yuv = port_fused.upload_planes(yuv, CPU)
    pairs = [
        (jax_pixel.unpack_rgba1010102(jnp.asarray(rgba)),
         port_pixel.unpack_rgba1010102(t_rgba)),
        (jax_pixel.unpack_rgba8888(jnp.asarray(rgba)),
         port_pixel.unpack_rgba8888(t_rgba)),
        (jax_pixel.unpack_rgbaf16(jnp.asarray(f16)),
         port_pixel.unpack_rgbaf16(t_f16)),
    ]
    for rng in (port.ColorRange.FULL, port.ColorRange.LIMITED):
        pairs.append((jax_pixel.unpack_yuv444_10(
            *(jnp.asarray(p) for p in yuv), jax_types.ColorRange(int(rng))),
            port_pixel.unpack_yuv444_10(*t_yuv, rng)))
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(pairs[2][1].numpy()).all()


def test_pack_rgba8888_yuv444_and_sanitize_match_jax():
    rs = np.random.RandomState(6)
    x = rs.uniform(-0.2, 1.2, (3, 19, 21)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(
        port_pixel.pack_rgba8888(tx).numpy().view(np.uint32),
        np.asarray(jax_pixel.pack_rgba8888(jx)))
    for got, want in zip(port_pixel.pack_yuv444(tx - 0.5),
                         jax_pixel.pack_yuv444(jx - 0.5)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    special = np.array([np.nan, np.inf, -np.inf, -1.0, 0.5, 60.0],
                       np.float32)
    np.testing.assert_array_equal(
        port_colors.sanitize_pixel(torch.from_numpy(special)).numpy(),
        np.asarray(jax_colors.sanitize_pixel(jnp.asarray(special))))
    for cg in (CG.BT709, CG.DISPLAY_P3, CG.BT2100):
        np.testing.assert_array_equal(
            port_colors.rgb2yuv_matrix_for_gamut(cg),
            jax_colors.rgb2yuv_matrix_for_gamut(int(cg)))


@pytest.mark.parametrize("w,h", [(64, 48), (130, 66)])
def test_photo_rgb_twins_match_benchmarks(w, h):
    import benchmarks
    p010 = benchmarks.photo_p010(w, h)
    for want, got in ((benchmarks._p010_to_rgba1010102(p010),
                       testing.photo_rgba1010102(w, h)),
                      (benchmarks._p010_to_rgbaf16(p010),
                       testing.photo_rgbaf16(w, h))):
        assert (int(want.fmt), int(want.cg), int(want.ct), int(want.range),
                want.w, want.h) == (int(got.fmt), int(got.cg), int(got.ct),
                                    int(got.range), got.w, got.h)
        assert want.planes[0].dtype == got.planes[0].dtype
        np.testing.assert_array_equal(want.planes[0], got.planes[0])
    yuv = testing.photo_yuv444_10(w, h)
    np.testing.assert_array_equal(
        yuv.planes[0], testing.photo_rgba1010102(w, h).planes[0] & 1023)

