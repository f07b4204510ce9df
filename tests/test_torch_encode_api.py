"""PyTorch port: the API-1 encode (raw HDR + raw SDR) and its two-pass gain
map against the JAX package.

The HDR is ``testing.photo_p010`` at 72x40 (4:2:0 MCUs and the scale-4 map
need padding).  Three SDR intents: the JAX package's own ``tone_map`` of
the HDR (YUV420, Display-P3), and two made with numpy from a seed from
it, a YUV420 and an RGBA8888 labelled BT.709, so that the base's YUV
re-encoding to BT.601 is not the identity.  API-1 runs for {YUV420 P3,
RGBA8888 BT.709} x {REALTIME, BEST_QUALITY} in the library's default
configuration (map scale 1, 3-channel map) and once, YUV420 BT.709 with
BEST_QUALITY, in the reference benchmark's (scale 4, one channel).  The
port encodes on the CPU through ``UhdrEncoder`` with the JAX JpegR's knobs.

- The JAX decoder reads the port's file at >= 60 dB against its decode of
  the JAX file.
- Fed the JAX file's quantised coefficients (and, for BEST_QUALITY, the
  JAX package's own boost bounds), the port's entropy stage and container
  writer give the JAX file byte for byte.
- The base's u8 planes and the gain map agree within 1 on at most 1e-3 of
  the samples (at least one); the two-pass float gains agree within 1e-5
  (relative, to at least 1) and the bounds within 1e-5 relative: log2 and
  pow differ between the frameworks by an ulp now and then.  The file's
  coefficients equal the JAX file's except at DCT rounding ties, in every
  block whose u8 samples agree.
"""

import functools
from unittest import mock

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

import libultrahdr_tpu_torch as port
from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg import pack_kernel as port_pk
from libultrahdr_tpu_torch.jpeg.tables import (STD_CHROMA_QUANT,
                                               STD_LUMA_QUANT, ZIGZAG_ORDER,
                                               scaled_quant_table)
from libultrahdr_tpu_torch.ops import colors as port_colors
from libultrahdr_tpu_torch.ops import gainmap as port_gainmap
from libultrahdr_tpu_torch.ops import pixel as port_pixel

from test_torch_jax_native import guard_jax_native

guard_jax_native()

W, H = 72, 40
CPU = torch.device("cpu")
Fmt, CG, CT = port.ImgFmt, port.ColorGamut, port.ColorTransfer
RT, BQ = port.EncPreset.REALTIME, port.EncPreset.BEST_QUALITY
CONFIGS = {
    "default": {},
    "benchmark": {"map_dimension_scale_factor": 4,
                  "use_multi_channel_gainmap": False},
}
# name -> (SDR intent, preset, configuration)
CASES = {
    "yuv420_p3_realtime": ("yuv420_p3", RT, "default"),
    "yuv420_p3_best": ("yuv420_p3", BQ, "default"),
    "rgba8888_bt709_realtime": ("rgba8888_bt709", RT, "default"),
    "rgba8888_bt709_best": ("rgba8888_bt709", BQ, "default"),
    "yuv420_bt709_best_benchmark": ("yuv420_bt709", BQ, "benchmark"),
}


def to_jax(img):
    return jax_types.RawImage(int(img.fmt), int(img.cg), int(img.ct),
                              int(img.range), img.w, img.h,
                              [np.asarray(p) for p in img.planes])


def to_port(img):
    return port.RawImage(Fmt(int(img.fmt)), CG(int(img.cg)),
                         CT(int(img.ct)), port.ColorRange(int(img.range)),
                         img.w, img.h, [np.array(p) for p in img.planes])


@functools.lru_cache(maxsize=None)
def hdr_image():
    return testing.photo_p010(W, H)


@functools.lru_cache(maxsize=None)
def sdr_image(kind):
    """The SDR intent: the JAX tone map of the HDR, or a seeded numpy
    variant of it labelled BT.709."""
    p3 = to_port(jax_jpegr.JpegR().tone_map(to_jax(hdr_image())))
    if kind == "yuv420_p3":
        return p3
    rs = np.random.RandomState(17)
    if kind == "yuv420_bt709":
        planes = [np.clip(p.astype(np.int32) + rs.randint(-3, 4, p.shape),
                          0, 255).astype(np.uint8) for p in p3.planes]
        return port.RawImage(Fmt.YUV420, CG.BT709, CT.SRGB,
                             port.ColorRange.FULL, W, H, planes)
    y = p3.planes[0].astype(np.float32)
    u, v = (np.repeat(np.repeat(p.astype(np.float32) - 128.0, 2, 0), 2, 1)
            for p in p3.planes[1:])
    rgb = np.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v,
                    y + 1.772 * u]) + rs.randint(-3, 4, (3, H, W))
    q = np.clip(np.rint(rgb), 0, 255).astype(np.uint32)
    packed = q[0] | (q[1] << 8) | (q[2] << 16) | np.uint32(0xFF000000)
    return port.RawImage(Fmt.RGBA8888, CG.BT709, CT.SRGB,
                         port.ColorRange.FULL, W, H, [packed])


def knobs(case):
    _, preset, cfg = CASES[case]
    return dict(CONFIGS[cfg], preset=preset)


@functools.lru_cache(maxsize=None)
def encodes(case):
    """(JAX file, port file, the JAX encode's resolved (lo, hi) or None) of
    an API-1 request."""
    kind, preset, cfg = CASES[case]
    hdr, sdr = hdr_image(), sdr_image(kind)
    kw = knobs(case)
    bounds = []

    def recorded(*a, **k):
        bounds.append(resolve(*a, **k))
        return bounds[-1]
    resolve = jax_gainmap.resolve_boost_bounds
    with mock.patch.object(jax_gainmap, "resolve_boost_bounds", recorded):
        jax_file = jax_jpegr.JpegR(
            **dict(kw, preset=jax_types.EncPreset(int(preset)))).encode_api1(
                to_jax(hdr), to_jax(sdr), 95)
    assert len(bounds) == (preset == BQ)
    enc = port.UhdrEncoder(device="cpu")
    enc.set_raw_image(hdr, port.ImgLabel.HDR)
    enc.set_raw_image(sdr, port.ImgLabel.SDR)
    enc.set_quality(95, port.ImgLabel.BASE)
    enc.set_preset(preset)
    enc.set_gainmap_scale_factor(kw.get("map_dimension_scale_factor", 1))
    enc.set_using_multi_channel_gainmap(
        kw.get("use_multi_channel_gainmap", True))
    return jax_file, enc.encode(), bounds[0] if bounds else None


@functools.lru_cache(maxsize=None)
def jax_decode(data):
    out, _, _ = jax_jpegr.JpegR().decode(data, jax_types.ColorTransfer.HLG,
                                         jax_types.ImgFmt.RGBA1010102)
    packed = np.asarray(out.planes[0]).astype(np.int64)
    return np.stack([(packed >> s) & 1023 for s in (0, 10, 20)])


def layouts(case):
    """(map scale, [base layout, map layout]) of a case."""
    kind, _, cfg = CASES[case]
    kw = CONFIGS[cfg]
    scale = kw.get("map_dimension_scale_factor", 1)
    base = port_fused._SAMPLING_420 if kind.startswith("yuv420") \
        else port_fused._SAMPLING_444
    gm = port_fused._SAMPLING_444 if kw.get("use_multi_channel_gainmap",
                                            True) \
        else port_fused._SAMPLING_400
    return scale, [port_fused._layout_for(H, W, base),
                   port_fused._layout_for(H // scale, W // scale, gm)]


def stage_values(side, case):
    """The API-1 device stages of one side ("jax" or "port"): (base u8
    planes, map u8 planes, gains or None, (lo, hi) or None)."""
    kind, preset, cfg = CASES[case]
    kw = CONFIGS[cfg]
    hdr, sdr = hdr_image(), sdr_image(kind)
    scale = kw.get("map_dimension_scale_factor", 1)
    multichannel = kw.get("use_multi_channel_gainmap", True)
    jax_side = side == "jax"
    enums = jax_types if jax_side else port
    sdr_fmt = enums.ImgFmt(int(sdr.fmt))
    sdr_cg, hdr_cg = enums.ColorGamut(int(sdr.cg)), enums.ColorGamut(
        int(hdr.cg))
    p3 = enums.ColorGamut.DISPLAY_P3
    fused = jax_fused if jax_side else port_fused
    if jax_side:
        sdr_vals = jax_pixel.unpack(to_jax(sdr))
        hdr_vals = jax_pixel.unpack(to_jax(hdr))
        planes = [jnp.asarray(p) for p in sdr.planes]
    else:
        sdr_vals = port_pixel.unpack(sdr, CPU)
        hdr_vals = port_pixel.unpack(hdr, CPU)
        planes = port_fused.upload_planes(sdr.planes, CPU)
    if sdr_fmt == enums.ImgFmt.YUV420:
        base = fused._convert_yuv_encoding_planes(
            tuple(planes), sdr_fmt, sdr_cg, p3, H, W)
    else:
        base = fused._convert_yuv_encoding_planes(
            fused._rgb_vals_to_yuv444_planes(sdr_vals, sdr_cg),
            enums.ImgFmt.YUV444, sdr_cg, p3, H, W)
    common = dict(sdr_fmt=sdr_fmt, hdr_fmt=enums.ImgFmt.P010, sdr_cg=sdr_cg,
                  hdr_cg=hdr_cg, ct=enums.ColorTransfer.HLG, scale=scale,
                  multichannel=multichannel, use_luminance=True,
                  sdr_is_601=False,
                  use_base_cg=port_fused._use_base_cg(CG(int(sdr_cg)),
                                                      CG(int(hdr_cg)),
                                                      False))
    gm_mod = jax_gainmap if jax_side else port_gainmap
    gains = bounds = None
    if preset == RT:
        gm = gm_mod.generate_gainmap_onepass(
            sdr_vals, hdr_vals, gamma=1.0, max_boost=1000.0 / 203.0,
            **common)
    else:
        gains, gmin, gmax = gm_mod.gainmap_float_pass(sdr_vals, hdr_vals,
                                                      **common)
        bounds = gm_mod.resolve_boost_bounds(
            np.asarray(gmin), np.asarray(gmax), multichannel=multichannel,
            min_content_boost=None, max_content_boost=None,
            merge_channels=False)
        if jax_side:
            gm = jax_gainmap.encode_gainmap_twopass(
                gains, jnp.asarray(bounds[0]), jnp.asarray(bounds[1]),
                np.float32(1.0))
        else:
            gm = port_gainmap.encode_gainmap_twopass(gains, *bounds, 1.0)
        gains = np.asarray(gains)
    gm = np.asarray(gm)
    if multichannel:
        gm_planes = [np.asarray(p) for p in fused._rgb_to_ycbcr(
            jnp.asarray(gm) if jax_side else torch.from_numpy(gm))]
    else:
        gm_planes = [gm[0]]
    return ([np.asarray(p) for p in base], gm_planes, gains, bounds)


@functools.lru_cache(maxsize=None)
def stages(case):
    return stage_values("jax", case), stage_values("port", case)


def close_u8(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert a.shape == b.shape and diff.max() <= 1
    assert (diff > 0).sum() <= max(1, 1e-3 * diff.size)


@pytest.mark.parametrize("case", CASES)
def test_api1_port_file_decodes_in_jax_at_60db(case):
    jax_file, port_file, _ = encodes(case)
    ref, got = jax_decode(jax_file), jax_decode(port_file)
    assert got.shape == ref.shape == (3, H, W)
    mse = np.mean((got - ref).astype(np.float64) ** 2)
    psnr = np.inf if mse == 0 else 10 * np.log10(1023.0 ** 2 / mse)
    assert psnr >= 60.0, psnr


@pytest.mark.parametrize("case", CASES)
def test_api1_jax_coefficients_and_bounds_through_port_give_jax_file(case):
    """The JAX file's coefficients (one pack of both scans), the JAX
    package's bounds for BEST_QUALITY, the port's entropy stage and
    container writer: the JAX file, byte for byte."""
    kind, preset, cfg = CASES[case]
    jax_file, _, jax_bounds = encodes(case)
    primary, gm_jpeg, _ = testing.read_jpegr(jax_file)
    pjr = port.JpegR(device="cpu", **knobs(case))
    scale, lays = layouts(case)
    scans = [([torch.from_numpy(c) for c in
               testing.decode_scan_coeffs(jpeg, lay)], lay)
             for jpeg, lay in zip((primary, gm_jpeg), lays)]
    sdr = sdr_image(kind)
    use_base_cg = port_fused._use_base_cg(CG(sdr.cg), CG.BT2100, False)
    if preset == RT:
        md = port_fused._onepass_metadata(pjr, CT.HLG, use_base_cg)
    else:
        lo, hi = jax_bounds
        md = port_fused._twopass_metadata(pjr, CT.HLG, lo, hi, use_base_cg)
    out = port_fused._pack_and_assemble(
        pjr, W, H, 95, scans, lays[0].sampling, CG(sdr.cg), scale, md, None,
        CT.HLG, CG.BT2100, port_pk.pack_scan)
    assert out == jax_file


def _exact_ratio(plane_u8, q):
    """x/q of the float64 FDCT of a padded plane, zigzag order
    (bh, bw, 64)."""
    k = np.arange(8)
    d = 0.5 * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    d[0, :] = np.sqrt(1.0 / 8.0)
    h, w = plane_u8.shape
    x = plane_u8.astype(np.float64) - 128.0
    b = x.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    r = (d @ b @ d.T) / np.asarray(q, np.float64).reshape(8, 8)
    return r.reshape(h // 8, w // 8, 64)[..., ZIGZAG_ORDER]


def _padded(plane, layout, i):
    hs, vs = layout.sampling[i]
    return port_fused._pad_edge(torch.from_numpy(np.array(plane)),
                                layout.mcus_h * vs * 8,
                                layout.mcus_w * hs * 8).numpy()


@pytest.mark.parametrize("case", CASES)
def test_api1_stages_and_coefficients_match_jax(case):
    (jb, jg, jgains, jbounds), (pb, pg, pgains, pbounds) = stages(case)
    for a, b in zip(pb + pg, jb + jg):
        close_u8(a, b)
    if jgains is not None:
        np.testing.assert_allclose(pgains, jgains, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(jgains).max()))
        for a, b in zip(pbounds, jbounds):
            np.testing.assert_allclose(a, b, rtol=1e-5)
    jax_file, port_file, _ = encodes(case)
    _, lays = layouts(case)
    for i, (planes_p, planes_j) in enumerate(((pb, jb), (pg, jg))):
        layout = lays[i]
        jpeg_j = testing.read_jpegr(jax_file)[i]
        jpeg_p = testing.read_jpegr(port_file)[i]
        quality = 95
        for c, (cj, cp) in enumerate(zip(
                testing.decode_scan_coeffs(jpeg_j, layout),
                testing.decode_scan_coeffs(jpeg_p, layout))):
            q = scaled_quant_table(STD_CHROMA_QUANT if c else STD_LUMA_QUANT,
                                   quality)
            xj = _padded(planes_j[c], layout, c)
            xp = _padded(planes_p[c], layout, c)
            bh, bw = cj.shape[:2]
            same = (xj == xp).reshape(bh, 8, bw, 8).all(axis=(1, 3))
            ratio = _exact_ratio(xj, q)
            near_tie = np.abs(np.abs(ratio - np.round(ratio)) - 0.5) < 1e-3
            differ = cj != cp
            assert not (differ & ~near_tie & same[..., None]).any(), (i, c)
            assert np.abs(cj.astype(np.int32) - cp).max() <= 1


# ---- the ops of the slice against their JAX twins -------------------------

def test_yuv_encoding_conversion_matrices_equal():
    for src in (CG.BT709, CG.DISPLAY_P3, CG.BT2100):
        for dst in (CG.BT709, CG.DISPLAY_P3, CG.BT2100):
            want = jax_colors.yuv_encoding_conversion_matrix(int(src),
                                                             int(dst))
            got = port_colors.yuv_encoding_conversion_matrix(src, dst)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)


def _raw_images(rs):
    """One small image of every format the unpack dispatcher takes."""
    h, w = 10, 14
    u8 = lambda *s: rs.randint(0, 256, s).astype(np.uint8)  # noqa: E731
    u16 = lambda *s: rs.randint(0, 1024, s).astype(np.uint16)  # noqa: E731
    u32 = rs.randint(0, 2 ** 32, (h, w), dtype=np.uint64).astype(np.uint32)
    f16 = rs.uniform(-1.0, 60.0, (h, w, 4)).astype(np.float16).view(
        np.uint16)
    f16.reshape(-1)[:4] = [0x7C00, 0xFE01, 0x8000, 0x0001]
    imgs = {Fmt.YUV444: [u8(h, w), u8(h, w), u8(h, w)],
            Fmt.YUV422: [u8(h, w), u8(h, w // 2), u8(h, w // 2)],
            Fmt.YUV420: [u8(h, w), u8(h // 2, w // 2), u8(h // 2, w // 2)],
            Fmt.YUV400: [u8(h, w)],
            Fmt.P010: [u16(h, w) << 6, u16(h // 2, w) << 6],
            Fmt.YUV444_10: [u16(h, w), u16(h, w), u16(h, w)],
            Fmt.RGBA8888: [u32], Fmt.RGB888: [u8(h, w, 3)],
            Fmt.RGBA1010102: [u32], Fmt.RGBAF16: [f16]}
    return {f: port.RawImage(f, CG.BT709, CT.SRGB, rng, w, h, planes)
            for f, planes in imgs.items()
            for rng in ((port.ColorRange.FULL, port.ColorRange.LIMITED)
                        if f in (Fmt.P010, Fmt.YUV444_10)
                        else (port.ColorRange.FULL,))}


def test_unpack_every_format_exact():
    for fmt, img in _raw_images(np.random.RandomState(3)).items():
        want = np.asarray(jax_pixel.unpack(to_jax(img)))
        got = port_pixel.unpack(img, CPU).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(fmt))
        # planes already on the device unpack alike
        img.planes = port_fused.upload_planes(img.planes, CPU)
        np.testing.assert_array_equal(port_pixel.unpack(img, CPU).numpy(),
                                      want)


@pytest.mark.parametrize("multichannel,lo,hi,merge", [
    (True, None, None, False), (True, None, None, True),
    (False, None, None, False), (True, 1.5, 3.0, False),
    (True, 0.5, 2.0, True), (False, 1.0, 1.0, False)])
def test_resolve_boost_bounds_exact(multichannel, lo, hi, merge):
    rs = np.random.RandomState(int(multichannel) + 2 * int(merge))
    gmin = rs.uniform(-20.0, 1.0, 3).astype(np.float32)
    gmax = rs.uniform(0.0, 20.0, 3).astype(np.float32)
    gmax[2] = gmin[2]               # equal bounds are separated by 0.1
    kw = dict(multichannel=multichannel, min_content_boost=lo,
              max_content_boost=hi, merge_channels=merge)
    for got, want in zip(port_gainmap.resolve_boost_bounds(gmin, gmax, **kw),
                         jax_gainmap.resolve_boost_bounds(gmin, gmax, **kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gamma", [1.0, 1.571])
def test_encode_gainmap_twopass_matches_jax(gamma):
    rs = np.random.RandomState(9)
    gains = rs.uniform(-3.0, 4.0, (3, 24, 40)).astype(np.float32)
    lo = np.array([-2.5, -1.0, -3.5], np.float32)
    hi = np.array([3.0, 2.5, 4.5], np.float32)
    want = np.asarray(jax_gainmap.encode_gainmap_twopass(
        jnp.asarray(gains), jnp.asarray(lo), jnp.asarray(hi),
        np.float32(gamma)))
    got = port_gainmap.encode_gainmap_twopass(torch.from_numpy(gains), lo,
                                              hi, gamma).numpy()
    close_u8(got, want)
