"""One-pass gain map generation: log2(HDR/SDR) quantised to u8.

Port of the one-pass half of ``libultrahdr_tpu/ops/gainmap.py``, after
JpegR::generateGainMap (jpegr.cpp:712-828) and encodeGain
(gainmapmath.cpp:753-771).  Inputs are the unpacked (3, H, W) float32 SDR
and HDR gamma values; output is the (C, H//scale, W//scale) u8 gain map,
C = 3 per-channel or 1 maxRGB/luminance.  The two-pass (best-quality)
functions come with the other encode paths (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import RGB_FORMATS, ColorGamut, ColorTransfer, ImgFmt
from . import colors, pixel
from .lut_parity import SRGB_INV_OETF_N, lut_quantize


class GainmapPrep(NamedTuple):
    """Linear-light SDR/HDR values at gain map resolution."""

    sdr_rgb: torch.Tensor  # (3, mh, mw) linear SDR, [0,1] scale
    hdr_rgb: torch.Tensor  # (3, mh, mw) linear HDR, [0,1] scale
    hdr_sample_to_nits: float


def _prep(sdr_vals, hdr_vals, sdr_fmt, hdr_fmt, sdr_cg, hdr_cg, ct,
          scale: int, sdr_is_601: bool, use_base_cg: bool) -> GainmapPrep:
    """Box-downsample by `scale`, YUV->RGB, LUT-grid sRGB inverse OETF for
    SDR, inverse OETF + OOTF for HDR, gamut conversion to the common space,
    clip negatives (jpegr.cpp:746-788)."""
    sdr_ds = pixel.box_downsample(sdr_vals, scale)
    hdr_ds = pixel.box_downsample(hdr_vals, scale)

    if ImgFmt(sdr_fmt) in RGB_FORMATS:
        sdr_rgb_gamma = sdr_ds
    else:
        m = colors.P3_YUV2RGB if sdr_is_601 \
            else colors.yuv2rgb_matrix_for_gamut(sdr_cg)
        sdr_rgb_gamma = colors.yuv_to_rgb(sdr_ds, m)
    sdr_rgb = colors.srgb_inv_oetf(
        lut_quantize(torch.clamp(sdr_rgb_gamma, 0.0, 1.0), SRGB_INV_OETF_N))

    if ImgFmt(hdr_fmt) in RGB_FORMATS:
        hdr_rgb_gamma = hdr_ds
    else:
        hdr_rgb_gamma = colors.yuv_to_rgb(
            hdr_ds, colors.yuv2rgb_matrix_for_gamut(hdr_cg))
    hdr_rgb = colors.ootf(colors.inv_oetf(hdr_rgb_gamma, ct), ct)

    # gamut conversion direction (jpegr.cpp:600-646): with use_base_cg the
    # HDR goes into the SDR gamut, else the SDR into the HDR gamut
    if ColorGamut(sdr_cg) != ColorGamut(hdr_cg):
        if use_base_cg:
            hdr_rgb = colors.convert_gamut(
                hdr_rgb, colors.gamut_conversion_matrix(sdr_cg, hdr_cg))
        else:
            sdr_rgb = colors.convert_gamut(
                sdr_rgb, colors.gamut_conversion_matrix(hdr_cg, sdr_cg))
    sdr_rgb = colors.clip_negatives(sdr_rgb)
    hdr_rgb = colors.clip_negatives(hdr_rgb)

    hdr_white_nits = colors.reference_display_peak_nits(ct)
    to_nits = colors.SDR_WHITE_NITS \
        if ColorTransfer(ct) == ColorTransfer.LINEAR else hdr_white_nits
    return GainmapPrep(sdr_rgb, hdr_rgb, to_nits)


def _nits_pair(prep: GainmapPrep, multichannel: bool, use_luminance: bool,
               sdr_cg):
    """SDR/HDR nits: per channel (3,mh,mw) or maxRGB/luma (1,mh,mw)."""
    if multichannel:
        return (prep.sdr_rgb * colors.SDR_WHITE_NITS,
                prep.hdr_rgb * prep.hdr_sample_to_nits)
    if use_luminance:
        lum = colors.luminance_coeffs_for_gamut(sdr_cg)
        s = colors.luminance(prep.sdr_rgb, lum)
        h = colors.luminance(prep.hdr_rgb, lum)
    else:
        s = torch.amax(prep.sdr_rgb, dim=0)
        h = torch.amax(prep.hdr_rgb, dim=0)
    return ((s * colors.SDR_WHITE_NITS)[None],
            (h * prep.hdr_sample_to_nits)[None])


def encode_gain(sdr_nits: torch.Tensor, hdr_nits: torch.Tensor,
                min_boost: float, max_boost: float,
                gamma: float) -> torch.Tensor:
    """encodeGain (gainmapmath.cpp:753-771): u8 = trunc(pow(norm, gamma) *
    255), norm the log2 gain between the boosts."""
    f32 = dict(dtype=torch.float32, device=sdr_nits.device)
    lo_b = torch.tensor(min_boost, **f32)
    hi_b = torch.tensor(max_boost, **f32)
    gain = torch.where(sdr_nits > 0.0,
                       hdr_nits / torch.clamp(sdr_nits, min=1e-37), 1.0)
    gain = torch.minimum(torch.maximum(gain, lo_b), hi_b)
    log2min, log2max = torch.log2(lo_b), torch.log2(hi_b)
    norm = (torch.log2(gain) - log2min) / (log2max - log2min)
    norm_g = torch.pow(norm, torch.tensor(gamma, **f32))
    return torch.clamp(norm_g * 255.0, 0.0, 255.0).to(torch.uint8)


def generate_gainmap_onepass(sdr_vals, hdr_vals, *, sdr_fmt, hdr_fmt,
                             sdr_cg, hdr_cg, ct, scale: int,
                             multichannel: bool, gamma: float,
                             use_luminance: bool, sdr_is_601: bool,
                             use_base_cg: bool,
                             max_boost: float) -> torch.Tensor:
    """One-pass (REALTIME) gain map (jpegr.cpp:712-828): the metadata is
    fixed beforehand (max_content_boost = hdr_white / 203 passed in as
    `max_boost`, min 1).  Returns (C, mh, mw) uint8."""
    prep = _prep(sdr_vals, hdr_vals, sdr_fmt, hdr_fmt, sdr_cg, hdr_cg, ct,
                 scale, sdr_is_601, use_base_cg)
    sdr_nits, hdr_nits = _nits_pair(prep, multichannel, use_luminance,
                                    sdr_cg)
    return encode_gain(sdr_nits, hdr_nits, 1.0, max_boost, gamma)
