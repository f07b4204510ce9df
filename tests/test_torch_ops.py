"""PyTorch port: the pixel stages of the API-0 P010 encode against the JAX
package, on the same seeded inputs.

Tolerances: the P010 unpack is exact.  The tone map and the gain map are
float pipelines whose log2/pow/exp differ between the two frameworks by an
ulp now and then; such an ulp can flip the truncation of encode_gain
(ops/gainmap.py) or the rounding of pixel._scale_u8, so their u8 planes may
differ by 1 on at most 1e-3 of the samples.  The DCT sums in another order,
so a quantised coefficient may differ only where x/q lies within 1e-3 of a
rounding tie."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libultrahdr_tpu import fused as jax_fused
from libultrahdr_tpu.jpeg import dct as jax_dct
from libultrahdr_tpu.jpeg.tables import (STD_CHROMA_QUANT, STD_LUMA_QUANT,
                                         ZIGZAG_ORDER, scaled_quant_table)
from libultrahdr_tpu.ops import gainmap as jax_gainmap
from libultrahdr_tpu.ops import pixel as jax_pixel
from libultrahdr_tpu.ops import tonemap as jax_tonemap
from libultrahdr_tpu.types import (ColorGamut, ColorRange, ColorTransfer,
                                   ImgFmt)

from libultrahdr_tpu_torch import fused as port_fused
from libultrahdr_tpu_torch import testing
from libultrahdr_tpu_torch.jpeg import dct as port_dct
from libultrahdr_tpu_torch.ops import gainmap as port_gainmap
from libultrahdr_tpu_torch.ops import pixel as port_pixel
from libultrahdr_tpu_torch.ops import tonemap as port_tonemap

from test_torch_jax_native import guard_jax_native

guard_jax_native()

SIZES = [(64, 48), (130, 66)]
CPU = torch.device("cpu")


def _img(w, h, rng):
    img = testing.photo_p010(w, h, seed=w + h)
    img.range = rng
    return img


def _assert_u8_close(a, b):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def _hdr_pair(img):
    jy, juv = jnp.asarray(img.planes[0]), jnp.asarray(img.planes[1])
    ty, tuv = port_fused.upload_p010(img, CPU)
    rng = ColorRange(img.range)
    return (jax_pixel.unpack_p010(jy, juv, rng, img.h, img.w),
            port_pixel.unpack_p010(ty, tuv, int(rng), img.h, img.w))


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("rng", [ColorRange.FULL, ColorRange.LIMITED])
def test_unpack_p010_exact(w, h, rng):
    hj, ht = _hdr_pair(_img(w, h, rng))
    np.testing.assert_array_equal(np.asarray(hj), ht.numpy())


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("cg", [ColorGamut.BT2100, ColorGamut.DISPLAY_P3])
def test_tonemap_to_yuv(w, h, cg):
    hj, ht = _hdr_pair(_img(w, h, ColorRange.FULL))
    yj = jax_tonemap.tonemap_to_yuv(hj, ImgFmt.P010, cg, ColorTransfer.HLG,
                                    out_yuv420=True)
    yt = port_tonemap.tonemap_to_yuv(ht, ImgFmt.P010, int(cg),
                                     int(ColorTransfer.HLG))
    for a, b in zip(yj, yt):
        _assert_u8_close(a, b.numpy())


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("scale,multichannel", [(1, True), (4, False)])
def test_generate_gainmap_onepass(w, h, scale, multichannel):
    """Both configurations of the main path: the library default (scale 1,
    3-channel) and the reference benchmark's (scale 4, maxRGB)."""
    hj, ht = _hdr_pair(_img(w, h, ColorRange.FULL))
    yj = jax_tonemap.tonemap_to_yuv(hj, ImgFmt.P010, ColorGamut.BT2100,
                                    ColorTransfer.HLG, out_yuv420=True)
    y8 = [np.asarray(p) for p in yj]
    sj = jax_pixel.unpack_yuv8(*[jnp.asarray(p) for p in y8], 2, 2, h, w)
    st = port_pixel.unpack_yuv8(*[torch.from_numpy(p.copy()) for p in y8],
                                2, 2, h, w)
    kw = dict(sdr_fmt=ImgFmt.YUV420, hdr_fmt=ImgFmt.P010,
              sdr_cg=ColorGamut.DISPLAY_P3, hdr_cg=ColorGamut.BT2100,
              ct=ColorTransfer.HLG, scale=scale, multichannel=multichannel,
              gamma=1.0, use_luminance=False, sdr_is_601=False,
              use_base_cg=False, max_boost=1000.0 / 203.0)
    gj = jax_gainmap.generate_gainmap_onepass(sj, hj, **kw)
    gt = port_gainmap.generate_gainmap_onepass(st, ht, **kw)
    assert tuple(gt.shape) == ((3 if multichannel else 1), h // scale,
                               w // scale)
    _assert_u8_close(gj, gt.numpy())


def _exact_ratio(plane_u8, q):
    """x/q of the float64 FDCT, natural order (bh, bw, 8, 8)."""
    k = np.arange(8)
    d = 0.5 * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    d[0, :] = np.sqrt(1.0 / 8.0)
    h, w = plane_u8.shape
    x = plane_u8.astype(np.float64) - 128.0
    b = x.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    return (d @ b @ d.T) / np.asarray(q, np.float64).reshape(8, 8)


@pytest.mark.parametrize("w,h", [(64, 48), (136, 72)])
@pytest.mark.parametrize("quality,chroma", [(95, False), (95, True),
                                            (60, False)])
def test_forward_plane(w, h, quality, chroma):
    rs = np.random.RandomState(w * quality + chroma)
    smooth = testing.photo_p010(w, h, seed=3).planes[0] >> 8
    noise = rs.randint(-40, 41, (h, w))
    plane = np.clip(smooth + noise, 0, 255).astype(np.uint8)
    q = scaled_quant_table(STD_CHROMA_QUANT if chroma else STD_LUMA_QUANT,
                           quality)
    cj = np.asarray(jax_dct.forward_plane(jnp.asarray(plane), q))
    ct = port_dct.forward_plane(torch.from_numpy(plane), q).numpy()
    assert ct.dtype == np.int16 and ct.shape == cj.shape
    ratio = _exact_ratio(plane, q).reshape(h // 8, w // 8, 64)
    ratio = ratio[..., ZIGZAG_ORDER]
    near_tie = np.abs(np.abs(ratio - np.round(ratio)) - 0.5) < 1e-3
    differ = cj != ct
    assert not (differ & ~near_tie).any()
    assert np.abs(cj.astype(np.int32) - ct).max() <= 1


def test_scan_coeffs_pads_like_jax():
    """MCU padding (edge replication) of odd-sized planes, then the DCT:
    the port's _scan_coeffs against the JAX package's on 4:2:0 planes of
    a 130x66 image (MCUs of 16x16 need 14x4 padding)."""
    rs = np.random.RandomState(5)
    planes = [rs.randint(0, 256, s).astype(np.uint8)
              for s in ((66, 130), (33, 65), (33, 65))]
    q = [scaled_quant_table(STD_LUMA_QUANT, 95),
         scaled_quant_table(STD_CHROMA_QUANT, 95),
         scaled_quant_table(STD_CHROMA_QUANT, 95)]
    cj, lj = jax_fused._scan_coeffs([jnp.asarray(p) for p in planes],
                                    jax_fused._SAMPLING_420, q)
    ct, lt = port_fused._scan_coeffs([torch.from_numpy(p) for p in planes],
                                     port_fused._SAMPLING_420, q)
    assert (lj.mcus_w, lj.mcus_h, lj.bpr) == (lt.mcus_w, lt.mcus_h, lt.bpr)
    np.testing.assert_array_equal(lj.is_luma, lt.is_luma)
    for a, b, p, qt in zip(cj, ct, planes, q):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        bh, bw = a.shape[:2]
        padded = np.pad(p, ((0, bh * 8 - p.shape[0]),
                            (0, bw * 8 - p.shape[1])), mode="edge")
        ratio = _exact_ratio(padded, qt).reshape(bh, bw, 64)
        ratio = ratio[..., ZIGZAG_ORDER]
        near_tie = np.abs(np.abs(ratio - np.round(ratio)) - 0.5) < 1e-3
        assert not ((a != b) & ~near_tie).any()


def test_pad_edge_and_rgb_to_ycbcr_match_jax():
    rs = np.random.RandomState(9)
    p = rs.randint(0, 256, (13, 21)).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(jax_fused._pad_edge(jnp.asarray(p), 16, 24)),
        port_fused._pad_edge(torch.from_numpy(p), 16, 24).numpy())
    rgb = rs.randint(0, 256, (3, 16, 24)).astype(np.uint8)
    for a, b in zip(jax_fused._rgb_to_ycbcr(jnp.asarray(rgb)),
                    port_fused._rgb_to_ycbcr(torch.from_numpy(rgb))):
        _assert_u8_close(a, b.numpy())
