"""PyTorch port: the cases of ``tests/test_fused_variants.py`` on the port,
on the CPU (``device="cpu"``): each fused encode route of the port (API-0
of RGBA1010102, RGBAF16 and YUV444_10; API-1 of P010, RGBA1010102 and
RGBAF16 HDR with YUV420 and RGBA8888 SDR, both presets; the boost
suggestions) against its general path (``use_fused=False``), at the JAX
file's tolerances: the same boosts (1e-5 relative) and base-gamut flag,
the same map size, map codes within 16 and their mean within 2, each
decoded HLG channel's mean difference under 2.5 codes; a YUV444_10 base
is 4:4:4.

The JAX file is marked slow for its XLA compiles of the fused-config
matrix; the port's routes run eagerly, so these cases run in the default
tier.
"""

import numpy as np
import pytest

from libultrahdr_tpu_torch.jpegr import JpegR as _JpegR, is_uhdr_image
from libultrahdr_tpu_torch.types import (ColorGamut, ColorRange,
                                         ColorTransfer, EncPreset, ImgFmt,
                                         RawImage)

W, H = 96, 64


def JpegR(**kw) -> _JpegR:
    return _JpegR(device="cpu", **kw)


def _rgba1010102():
    rs = np.random.RandomState(1)
    r = rs.randint(0, 1024, (H, W)).astype(np.uint32)
    g = rs.randint(0, 1024, (H, W)).astype(np.uint32)
    b = rs.randint(0, 1024, (H, W)).astype(np.uint32)
    packed = r | (g << 10) | (b << 20) | np.uint32(0x3 << 30)
    return RawImage(ImgFmt.RGBA1010102, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, W, H, [packed])


def _rgbaf16():
    rs = np.random.RandomState(2)
    vals = (rs.rand(H, W, 3) * 4.0).astype(np.float16)
    comp = np.zeros((H, W, 4), np.uint16)
    comp[..., :3] = vals.view(np.uint16)
    comp[..., 3] = 0x3C00
    return RawImage(ImgFmt.RGBAF16, ColorGamut.BT2100, ColorTransfer.LINEAR,
                    ColorRange.FULL, W, H, [comp])


def _p010():
    rs = np.random.RandomState(3)
    y = (rs.randint(0, 1024, (H, W)).astype(np.uint16) << 6)
    uv = (rs.randint(256, 768, (H // 2, W)).astype(np.uint16) << 6)
    return RawImage(ImgFmt.P010, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, W, H, [y, uv])


def _yuv420():
    rs = np.random.RandomState(4)
    return RawImage(ImgFmt.YUV420, ColorGamut.DISPLAY_P3, ColorTransfer.SRGB,
                    ColorRange.FULL, W, H,
                    [rs.randint(0, 256, (H, W)).astype(np.uint8),
                     rs.randint(64, 192, (H // 2, W // 2)).astype(np.uint8),
                     rs.randint(64, 192, (H // 2, W // 2)).astype(np.uint8)])


def _rgba8888():
    rs = np.random.RandomState(5)
    return RawImage(ImgFmt.RGBA8888, ColorGamut.BT709, ColorTransfer.SRGB,
                    ColorRange.FULL, W, H,
                    [rs.randint(0, 2**32, (H, W), np.uint64)
                     .astype(np.uint32) | np.uint32(0xFF000000)])


def _compare(fused_bytes, general_bytes, gm_tol=16):
    assert is_uhdr_image(fused_bytes) and is_uhdr_image(general_bytes)
    d_f, m_f, gm_f = JpegR().decode(fused_bytes, output_ct=ColorTransfer.HLG,
                                    return_gainmap=True)
    d_g, m_g, gm_g = JpegR().decode(general_bytes,
                                    output_ct=ColorTransfer.HLG,
                                    return_gainmap=True)
    np.testing.assert_allclose(m_f.max_content_boost, m_g.max_content_boost,
                               rtol=1e-5)
    np.testing.assert_allclose(m_f.min_content_boost, m_g.min_content_boost,
                               rtol=1e-5)
    assert m_f.use_base_cg == m_g.use_base_cg
    assert gm_f.w == gm_g.w and gm_f.h == gm_g.h
    gd = np.abs(gm_f.planes[0].astype(int) - gm_g.planes[0].astype(int))
    assert gd.max() <= gm_tol and gd.mean() < 2.0
    pf, pg = np.asarray(d_f.planes[0]), np.asarray(d_g.planes[0])
    for s in (0, 10, 20):
        ch = np.abs(((pf >> s) & 0x3FF).astype(int)
                    - ((pg >> s) & 0x3FF).astype(int))
        assert ch.mean() < 2.5


@pytest.mark.parametrize("img_fn", [_rgba1010102, _rgbaf16])
def test_api0_rgb_fused_matches_general(img_fn):
    img = img_fn()
    jr = JpegR(map_dimension_scale_factor=2, use_multi_channel_gainmap=False,
               preset=EncPreset.REALTIME)
    fused = jr.encode_api0(img, quality=92)
    general = jr.encode_api0(img, quality=92, use_fused=False)
    _compare(fused, general)


@pytest.mark.parametrize("sdr_fn", [_yuv420, _rgba8888])
@pytest.mark.parametrize("preset", [EncPreset.REALTIME,
                                    EncPreset.BEST_QUALITY])
def test_api1_fused_matches_general(sdr_fn, preset):
    hdr, sdr = _p010(), sdr_fn()
    jr = JpegR(map_dimension_scale_factor=2, use_multi_channel_gainmap=True,
               preset=preset)
    fused = jr.encode_api1(hdr, sdr, quality=92)
    general = jr.encode_api1(hdr, sdr, quality=92, use_fused=False)
    _compare(fused, general)


@pytest.mark.parametrize("hdr_fn", [_rgba1010102, _rgbaf16])
@pytest.mark.parametrize("preset", [EncPreset.REALTIME,
                                    EncPreset.BEST_QUALITY])
def test_api1_fused_rgb_hdr_matches_general(hdr_fn, preset):
    """API-1 with packed-RGB HDR inputs (the remaining reference benchmark
    configs, benchmark_test.cpp:68-72: rgba1010102 / rgba16F HDR)."""
    hdr, sdr = hdr_fn(), _yuv420()
    jr = JpegR(map_dimension_scale_factor=2, use_multi_channel_gainmap=True,
               preset=preset)
    fused = jr.encode_api1(hdr, sdr, quality=92)
    general = jr.encode_api1(hdr, sdr, quality=92, use_fused=False)
    _compare(fused, general)


def test_api1_fused_boost_suggestions():
    hdr, sdr = _p010(), _yuv420()
    jr = JpegR(map_dimension_scale_factor=2, use_multi_channel_gainmap=False,
               preset=EncPreset.BEST_QUALITY, min_content_boost=1.0,
               max_content_boost=4.0)
    fused = jr.encode_api1(hdr, sdr, quality=92)
    general = jr.encode_api1(hdr, sdr, quality=92, use_fused=False)
    _compare(fused, general)
    _, md, _ = JpegR().decode(fused, output_ct=ColorTransfer.HLG,
                              return_gainmap=True)
    assert float(md.max_content_boost[0]) <= 4.0 + 1e-4


def _yuv444_10():
    rs = np.random.RandomState(7)
    return RawImage(ImgFmt.YUV444_10, ColorGamut.BT2100, ColorTransfer.HLG,
                    ColorRange.FULL, W, H,
                    [rs.randint(0, 1024, (H, W)).astype(np.uint16),
                     rs.randint(256, 768, (H, W)).astype(np.uint16),
                     rs.randint(256, 768, (H, W)).astype(np.uint16)])


@pytest.mark.parametrize("multichannel", [False, True])
def test_api0_yuv444_10_fused_matches_general(multichannel):
    """30bpp YCbCr444 HDR input (jpegr.cpp:178-190): fused path produces a
    444-sampled base JPEG equivalent to the general path's."""
    img = _yuv444_10()
    jr = JpegR(map_dimension_scale_factor=2,
               use_multi_channel_gainmap=multichannel,
               preset=EncPreset.REALTIME)
    fused = jr.encode_api0(img, quality=92)
    general = jr.encode_api0(img, quality=92, use_fused=False)
    _compare(fused, general)
    # base image must really be 4:4:4 (jpegencoderhelper.cpp:26-43 row 444)
    from libultrahdr_tpu_torch.container import segments
    from libultrahdr_tpu_torch.jpeg import parse_jpeg
    r = segments.scan_jpeg_images(fused, limit=2)
    info = parse_jpeg(fused[r[0][0]:r[0][1]], parse_only=True)
    assert all(c.h == 1 and c.v == 1 for c in info.components)
