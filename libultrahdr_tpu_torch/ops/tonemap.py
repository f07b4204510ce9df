"""HDR -> SDR global tone mapping over whole planes.

Port of the parts of ``libultrahdr_tpu/ops/tonemap.py`` that the API-0 P010
encode runs, after JpegR::toneMap and globalTonemap/ReinhardMap
(jpegr.cpp:1813-2090):

    unpack -> YUV->RGB -> inverse OETF -> OOTF -> Reinhard(maxRGB)
           -> gamut(BT2100->P3) -> clamp -> sRGB OETF -> P3 RGB->YUV -> pack
"""

from __future__ import annotations

import torch

from ..types import RGB_FORMATS, ColorGamut, ColorTransfer, ImgFmt
from . import colors, pixel


def reinhard_map(y_hdr: torch.Tensor, headroom: float) -> torch.Tensor:
    """ReinhardMap (jpegr.cpp:1813-1817)."""
    out = (1.0 + y_hdr / (headroom * headroom)) / (1.0 + y_hdr)
    return out * y_hdr


def global_tonemap_rgb(rgb: torch.Tensor, headroom: float,
                       is_normalized: bool) -> torch.Tensor:
    """globalTonemap (jpegr.cpp:1819-1846) over (3, H, W); returns the SDR
    RGB."""
    rgb_hdr = rgb * headroom if is_normalized else rgb
    max_hdr = torch.amax(rgb_hdr, dim=0)
    max_sdr = reinhard_map(max_hdr, headroom)
    scale = torch.where(max_hdr > 0.0,
                        max_sdr / torch.clamp(max_hdr, min=1e-37), 0.0)
    return torch.where(rgb_hdr > 0.0, rgb_hdr * scale, 0.0)


def hdr_to_linear_rgb(hdr_vals: torch.Tensor, fmt: ImgFmt, cg: ColorGamut,
                      ct: ColorTransfer) -> torch.Tensor:
    """Gamma YUV/RGB (3,H,W) -> display-linear RGB: YUV->RGB per gamut for
    planar input, inverse OETF, HLG OOTF (jpegr.cpp:2015-2023)."""
    if ImgFmt(fmt) in RGB_FORMATS:
        rgb_gamma = hdr_vals
    else:
        rgb_gamma = colors.yuv_to_rgb(hdr_vals,
                                      colors.yuv2rgb_matrix_for_gamut(cg))
    return colors.ootf(colors.inv_oetf(rgb_gamma, ct), ct)


def tonemap_core(hdr_vals: torch.Tensor, fmt: ImgFmt, cg: ColorGamut,
                 ct: ColorTransfer) -> torch.Tensor:
    """HDR gamma values -> SDR P3 sRGB gamma RGB (3,H,W); the SDR colour
    aspects are forced to (P3, sRGB, full range) (jpegr.cpp:1985-1987)."""
    rgb = hdr_to_linear_rgb(hdr_vals, fmt, cg, ct)
    hdr_white_nits = colors.reference_display_peak_nits(ct)
    is_normalized = ColorTransfer(ct) != ColorTransfer.LINEAR
    sdr_rgb = global_tonemap_rgb(
        rgb, hdr_white_nits / colors.SDR_WHITE_NITS, is_normalized)
    gamut_m = colors.gamut_conversion_matrix(ColorGamut.DISPLAY_P3, cg)
    sdr_rgb = colors.clamp_pixel_float(colors.convert_gamut(sdr_rgb, gamut_m))
    return colors.srgb_oetf(sdr_rgb)


def tonemap_to_yuv(hdr_vals: torch.Tensor, fmt: ImgFmt, cg: ColorGamut,
                   ct: ColorTransfer):
    """Tonemap P010 input to YUV420 SDR planes (2x2 chroma average,
    jpegr.cpp:2044-2070).  The JAX package's 4:4:4 output for YUV444_10
    input comes with the other encode formats (ROADMAP Queue 1)."""
    sdr_rgb_gamma = tonemap_core(hdr_vals, fmt, cg, ct)
    sdr_yuv = colors.rgb_to_yuv(sdr_rgb_gamma, colors.P3_RGB2YUV)
    return pixel.pack_yuv420(sdr_yuv)
